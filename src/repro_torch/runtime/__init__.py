"""Runtime pieces of the port: the deadline failure detector the serving
watchdog reads (:class:`fault_tolerance.HeartbeatTable`)."""
