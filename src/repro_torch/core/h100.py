"""Published rates of one NVIDIA H100 SXM, the card the port runs on.

One place for the rates every kernel bound is computed from: the kernel
bench's roofline (``cost_model.mac_datapath_stats``) and ``chip_smoke.py``'s
``Card.bound`` both read them, so the two cannot drift apart.  These are
data-sheet peaks at the full 700 W power limit, not measurements.
"""

from __future__ import annotations

#: device memory rate of an H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: dense int8 tensor-core rate of an H100 SXM (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12
#: float32 rate outside the tensor cores of an H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12
#: the 32-bit popc unit's issue rate per SM per clock on compute capability
#: 9.0 (CUDA C Programming Guide, arithmetic instruction throughput table)
POPC_PER_CLOCK_PER_SM = 16
#: 32-bit integer add, shift and logic results per SM per clock on compute
#: capability 9.0 (CUDA C Programming Guide, arithmetic instruction
#: throughput table)
INT32_PER_CLOCK_PER_SM = 64
#: streaming multiprocessors and maximum SM clock of an H100 SXM
H100_SMS = 132
H100_MAX_SM_MHZ = 1980.0


def popc_ops_per_s(sms: int = H100_SMS,
                   max_sm_mhz: float = H100_MAX_SM_MHZ) -> float:
    """popc results per second: 16 a clock on each SM (4.18e12/s for an
    H100 SXM at 1980 MHz)."""
    return POPC_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6


def int32_ops_per_s(sms: int = H100_SMS,
                    max_sm_mhz: float = H100_MAX_SM_MHZ) -> float:
    """32-bit integer add / shift / logic results per second: 64 a clock on
    each SM (1.67e13/s for an H100 SXM at 1980 MHz)."""
    return INT32_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6
