"""Silent: imported.py line for line, without its torch import (names
differ: the symbol table knows compiled functions by bare name too)."""

_SIZES = [128, 256]


@compile
def choose(x):
    return x * _SIZES[0]                         # silent (line 9)


def _advance(x):
    return x + 1


quick = compile(_advance)


def caller(q):
    return quick([q, q]) + choose(q)             # silent (line 20)
