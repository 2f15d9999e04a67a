"""Speculative-decoding core of the port: the batched draft-then-verify
engine (``spec_decode``), the paper's analytical model (``analytical``) and
the profile -> LUT -> adaptive controller (``adaptive``)."""
