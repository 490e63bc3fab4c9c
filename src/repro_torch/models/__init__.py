"""Models of the port: the paper's FCN and the LM zoo (``lm.LM``:
dense and sliding-window attention, MLA, MoE, RG-LRU, Mamba-2 SSD and the
encoder-decoder)."""
from . import attention, blocks, common, convnets, lm, moe, recurrent  # noqa: F401
