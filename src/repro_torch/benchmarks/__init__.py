"""On-card runs of the port: the paper's FCN workload (``common``) and a
profile of one training step (``step_profile``)."""
