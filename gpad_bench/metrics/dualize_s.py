"""Seconds of the program's condensation and dualization in set-up
(``condense`` and ``dualize``, host float64), by the harness's clock
around them."""


def read(r: dict):
    return r.get("dualize_s")
