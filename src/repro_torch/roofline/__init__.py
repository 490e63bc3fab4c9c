"""Cost model and roofline of the port's op traces (``op_common``,
``op_cost``, ``analysis``); see ``op_cost``."""
