"""Distribution helpers of the port (rule templates so far)."""
