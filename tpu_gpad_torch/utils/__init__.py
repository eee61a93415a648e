from tpu_gpad_torch.utils.debug import solve_batch_checked, validate_data
from tpu_gpad_torch.utils.flops import solve_flops
from tpu_gpad_torch.utils.timing import (
    device_time_per_call,
    device_time_percentiles,
    device_time_stats,
    interleaved_ab,
    matmul_peak_tflops,
    wall_times,
)

__all__ = [
    "device_time_per_call",
    "device_time_percentiles",
    "device_time_stats",
    "interleaved_ab",
    "matmul_peak_tflops",
    "solve_flops",
    "wall_times",
    "solve_batch_checked",
    "validate_data",
]
