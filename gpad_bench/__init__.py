"""The benchmark of tpu_gpad_torch: see run.py."""
