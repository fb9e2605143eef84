"""A bare compile() counts where the imports make it torch.compile."""
from torch import compile

_SIZES = [128, 256]


@compile
def pick(x):
    return x * _SIZES[0]                         # finding (line 9)


def _step(x):
    return x + 1


fast = compile(_step)


def caller(q):
    return fast([q, q]) + pick(q)                # finding (line 20)
