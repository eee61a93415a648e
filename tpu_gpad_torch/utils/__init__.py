from tpu_gpad_torch.utils.timing import device_time_per_call

__all__ = ["device_time_per_call"]
