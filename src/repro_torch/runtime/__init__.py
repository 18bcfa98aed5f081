"""The runtime around the chunked driver: the chaos layer (fault
injection and the finite checks of ``chaos``).  The JAX package's
supervisor and compile cache are not ported yet."""

from repro_torch.runtime.chaos import (FaultInjector, SimulatedKill,
                                       carry_all_finite, carry_finite_flag,
                                       corrupt_checkpoint, poison_carry,
                                       request_burst)

__all__ = ["FaultInjector", "SimulatedKill", "carry_all_finite",
           "carry_finite_flag", "corrupt_checkpoint", "poison_carry",
           "request_burst"]
