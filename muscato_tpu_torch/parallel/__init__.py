"""Multi-process execution of the port: the device mesh and the multi-host runtime."""
