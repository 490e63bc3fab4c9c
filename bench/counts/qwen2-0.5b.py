"""Model FLOPs of one training step of qwen2-0.5b (all 24 layers).

6 x matmul parameters x tokens, for the forward and the backward pass (the
q, k, v, o projections, the SwiGLU MLP's three matrices and the tied head;
recomputation is not counted), plus the causal attention's score and value
products, 12 x layers x tokens x heads x head_dim x seq / 2.
"""
LAYERS, D_MODEL, HEADS, KV_HEADS, HEAD_DIM = 24, 896, 14, 2, 64
D_FF, VOCAB = 4864, 151936
MATMUL_PARAMS = (LAYERS * (2 * D_MODEL * HEADS * HEAD_DIM
                           + 2 * D_MODEL * KV_HEADS * HEAD_DIM
                           + 3 * D_MODEL * D_FF)
                 + VOCAB * D_MODEL)


def step_flops(mix) -> float:
    tokens = mix["batch"] * mix["seq"]
    attention = 12 * LAYERS * tokens * HEADS * HEAD_DIM * mix["seq"] / 2
    return 6 * MATMUL_PARAMS * tokens + attention
