"""PyTorch port of the ``repro`` package: SAMOA's streaming learners on one
NVIDIA H100, with hand-written CUDA kernels where ``repro`` has Pallas
kernels for the TPU.  It imports nothing of JAX or of ``repro``.

It holds three slices: the Vertical Hoeffding Tree prequential path
(``ml.htree``/``ml.vht``, the topology and engines of ``core``,
``core.evaluation``, ``data``; the ``tree_route``, ``vht_stats`` and
``split_gain`` kernels), AMRules regression (``ml.amrules``,
``ml.detectors``; the ``rule_stats`` kernel), and the LM zoo's serving path
for the dense and ssm families (``configs``, ``models``, ``launch``; the
``selective_scan`` and ``flash_attention`` kernels).  Entry points take
``device=None``, which means the CUDA card (see ``device.resolve_device``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
