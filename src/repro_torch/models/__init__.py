"""Models of the port: the paper's FCN and the decoder-only dense-attention
LMs (``lm.LM``)."""
from . import attention, blocks, common, convnets, lm, moe  # noqa: F401
