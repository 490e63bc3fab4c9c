"""The plain reference of one training step of the benchmark's cells.

Plain PyTorch, float32 with TF32 off, written from the published layer
equations and the paper's algorithm (E-RIDER, Alg. 3), with frozen copies
of the random chains the configuration fixes (``rng``). It imports no JAX,
nothing of the JAX package and nothing of the port: it takes the inputs
the benchmark makes (``bench.weights``, ``bench.traffic``) and works out
again every state the port derives from them.
"""
