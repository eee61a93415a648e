"""The benchmark's plain reference: each plant's condensation in NumPy
(``<plant>.py``, named by a configuration's ``plant`` key) and the GPAD
loop in float64 torch (``gpad.py``). It imports nothing of the program."""
