from tpu_gpad_torch.utils.debug import solve_batch_checked, validate_data
from tpu_gpad_torch.utils.flops import solve_flops
from tpu_gpad_torch.utils.timing import device_time_per_call

__all__ = ["device_time_per_call", "solve_batch_checked", "solve_flops",
           "validate_data"]
