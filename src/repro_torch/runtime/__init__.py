"""Runtime pieces of the port: the deadline failure detector the serving
watchdog reads, the straggler monitor and the resilient training loop
(:mod:`.fault_tolerance`)."""
