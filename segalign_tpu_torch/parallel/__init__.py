"""Work distribution of the port: the device farm, the host split and the
sharded seed table."""
