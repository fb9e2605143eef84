"""jit-retrace cases on torch's compiled boundaries."""
import functools

import torch

_TUNING_TABLE = {"block": 128}


@torch.compile
def compiled_capture(x):
    return x * _TUNING_TABLE["block"]            # finding (line 11)


@torch.jit.script
def scripted_capture(x):
    return x * _TUNING_TABLE["block"]            # finding (line 16)


@functools.partial(torch.compile, dynamic=False)
def partial_capture(x):
    return x * _TUNING_TABLE["block"]            # finding (line 21)


@torch.compile(mode="reduce-overhead")
def frozen_capture(x):
    return x * _TUNING_TABLE["block"]  # lint: jit-ok(frozen after import)


@functools.partial(torch.compile, dynamic=False)
def scale(x, n):
    return x * n


def _step(x):
    return x + 1


traced = torch.jit.trace(_step, (torch.ones(4),))


def caller(q):
    bad = scale([q, q], 4)                       # finding (line 42)
    good = scale(q, 8)
    scripted = scripted_capture({"q": q})        # finding (line 44)
    stepped = traced([q])                        # finding (line 45)
    return bad + good + scripted + stepped
