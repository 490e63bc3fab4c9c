"""Model FLOPs of one training step of mamba2-2.7b cut to 56 layers.

6 x matmul parameters x tokens for the forward and the backward pass (the
z, x, B, C, dt and out projections and the tied head; recomputation is not
counted), plus 3 x the SSD's chunked products, counted from their shapes
at chunk L: a token's 2 L H N (C B^T within its chunk), 2 L H P (the
intra-chunk output), 2 H P N (its chunk's state), 2 H N P (the output
from the state before the chunk) and 2 H P N / L (the recurrence over
chunks), per layer.
"""
LAYERS, D_MODEL, D_INNER, HEADS, HEAD_DIM = 56, 2560, 5120, 80, 64
D_STATE, GROUPS, CHUNK, VOCAB = 128, 1, 256, 50280
MATMUL_PARAMS = (LAYERS * (D_MODEL * (2 * D_INNER + 2 * GROUPS * D_STATE
                                      + HEADS) + D_INNER * D_MODEL)
                 + VOCAB * D_MODEL)
SSD_TOKEN_FWD = (2 * CHUNK * HEADS * D_STATE + 2 * CHUNK * HEADS * HEAD_DIM
                 + 4 * HEADS * HEAD_DIM * D_STATE
                 + 2 * HEADS * HEAD_DIM * D_STATE / CHUNK)


def step_flops(mix) -> float:
    tokens = mix["batch"] * mix["seq"]
    return (6 * MATMUL_PARAMS * tokens
            + 3 * LAYERS * tokens * SSD_TOKEN_FWD)
