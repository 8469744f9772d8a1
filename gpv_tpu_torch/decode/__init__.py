from .beam import beam_decode
from .greedy import greedy_decode

__all__ = ["beam_decode", "greedy_decode"]
