"""Distribution helpers of the port: rule templates and the fault-tolerance
runtime so far."""
