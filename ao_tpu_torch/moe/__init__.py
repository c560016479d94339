"""MoE subsystem: grouped quantized matmuls and a reference MoE layer.

PyTorch port of the inference half of ``ao_tpu/moe``: ``grouped.py`` (the
grouped matmul per quantized container, int4 experts through the
hand-written kernel K13) and ``layer.py`` (router, dispatch, combine, the
MoE FFN). The expert-parallel all-to-all (``ep.py``) and the fp8 / MXFP8
grouped training (``training.py``) come with later slices of the port.
"""

from ao_tpu_torch.moe.grouped import grouped_matmul
from ao_tpu_torch.moe.layer import MoEConfig, init_moe_params, moe_forward

__all__ = ["grouped_matmul", "MoEConfig", "init_moe_params", "moe_forward"]
