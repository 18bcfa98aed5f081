"""PyTorch port of the ``repro`` package: SAMOA's streaming learners on one
NVIDIA H100, with hand-written CUDA kernels where ``repro`` has Pallas
kernels for the TPU.  It imports nothing of JAX or of ``repro``.

It holds the Vertical Hoeffding Tree prequential path (``ml.htree``/
``ml.vht``, the topology and engines of ``core``, ``core.evaluation``,
``data``; the ``tree_route``, ``vht_stats`` and ``split_gain`` kernels),
AMRules regression (``ml.amrules``, ``ml.detectors``; the ``rule_stats``
kernel), the OzaBag/OzaBoost ensembles and ``ShardingEnsemble``
(``ml.ensemble``, ``ml.vht``, ``core.prng``; the ``split_poisson``
kernel), the LM zoo's serving path for the dense and ssm families
(``configs``, ``models``, ``launch``; the ``selective_scan`` and
``flash_attention`` kernels), compiled steps (``core.compiled``), and
CluStream clustering (``ml.clustream``; its CF scatter through the
``rule_stats`` kernel) on the chunked stream runtime (``ChunkedStream``,
``JitEngine.run_stream_chunked``, ``ChunkedPrequentialEvaluation``) with
mid-stream checkpoints (``checkpoint``).  Entry points take
``device=None``, which means the CUDA card (see ``device.resolve_device``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
