"""pdx_torch.register — image registration (port of ``pdx/register``):
phase correlation, dense optical flow (Farnebäck, DIS, TV-L1), ECC
parametric registration, and the registration-quality metric."""

from pdx_torch.register.phasecorr import (
    phase_correlate,
    estimate_shift_phasecorr,
    stabilize_translation_sequence,
    estimate_interframe_shifts,
)
from pdx_torch.register.farneback import (
    farneback_flow,
    farneback_register_sequence,
    farneback_flow_pairs,
    farneback_register_sequence_compose,
    compose_flow_chain,
)
from pdx_torch.register.dis import dis_flow
from pdx_torch.register.tvl1 import tvl1_flow
from pdx_torch.register.ecc import ecc_align, ecc_warp, ecc_register_sequence
from pdx_torch.register.quality import mean_flow_magnitude, registration_improvement

__all__ = [
    "phase_correlate",
    "estimate_shift_phasecorr",
    "stabilize_translation_sequence",
    "estimate_interframe_shifts",
    "farneback_flow",
    "farneback_register_sequence",
    "farneback_flow_pairs",
    "farneback_register_sequence_compose",
    "compose_flow_chain",
    "dis_flow",
    "tvl1_flow",
    "ecc_align",
    "ecc_warp",
    "ecc_register_sequence",
    "mean_flow_magnitude",
    "registration_improvement",
]
