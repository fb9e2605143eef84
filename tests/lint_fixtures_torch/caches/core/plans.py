"""The port's cache module, recognised under each of its spellings."""
import functools

import repro_torch.caches as port_caches
from repro_torch import caches
from repro_torch.caches import LRUCache
from repro_torch.core.planner import cost_model_token, structure_signature

_plans = caches.LRUCache("fixture-torch-plans", 8)
_preps = LRUCache("fixture-torch-preps", 8)
_progs = port_caches.LRUCache("fixture-torch-programs", 8)


def stale(a):
    key = (structure_signature(a), "plan")
    hit = _plans.get(key)                        # finding (line 16)
    prep = _preps.get(key)                       # finding (line 17)
    prog = _progs.get(key)                       # finding (line 18)
    return hit, prep, prog


def fresh(a):
    key = (structure_signature(a), cost_model_token())
    return _plans.get(key)                       # silent: token-carrying


@functools.lru_cache(maxsize=16)
def _memo(x):
    return x + 1                                 # silent: registered below


port_caches.register_lru("fixture-torch-memo", _memo)


@functools.lru_cache(maxsize=16)
def _unregistered(x):                            # finding (line 36)
    return x - 1
