"""The port's PrefixStore (its own copy of the reference module) against
``repro.serve.PrefixStore`` on one seeded op stream under byte pressure:
identical eviction logs, chain reference counters and metrics, for every
policy the serve path takes."""
import random

import pytest

pytest.importorskip("torch")

from repro.serve import PrefixStore as JaxStore  # noqa: E402
from repro_torch.core import POLICIES  # noqa: E402
from repro_torch.serve import PrefixStore as TorchStore  # noqa: E402

BT = 4
NBYTES = 50


def _drive(store, seed, n_ops=400, vocab=60):
    """Register/lookup/insert/complete, interleaved by a seeded stream.
    Payloads come from a factory (pool-row style), so evictions hand back
    ints. Returns the payloads evicted, in order, and every lookup's
    usable chain uids."""
    rng = random.Random(seed)
    families = [[rng.randrange(vocab) for _ in range(16)] for _ in range(5)]
    evicted, lookups, live = [], [], []
    store.evict_payload = evicted.append
    next_row = iter(range(1, 10 ** 6))

    def toks():
        fam = rng.choice(families)
        t = fam[:rng.randrange(BT, len(fam) + 1)]
        return t + [rng.randrange(vocab) for _ in range(rng.randrange(BT + 1))]

    for _ in range(n_ops):
        r = rng.random()
        if r < 0.3:
            t = toks()
            live.append((store.register_request(t), t))
        elif r < 0.45 and live:
            rid, t = live.pop(rng.randrange(len(live)))
            store.insert(t, lambda i, node: next(next_row), NBYTES)
            store.complete_request(rid)
        elif r < 0.75:
            lookups.append([n.uid for n in store.lookup(toks())])
        else:
            store.insert(toks(), lambda i, node: next(next_row), NBYTES)
    return evicted, lookups


@pytest.mark.parametrize("policy", sorted(p for p in POLICIES
                                          if p != "belady"))
def test_store_matches_reference(policy):
    cap = NBYTES * 12                  # well under the working set
    ref = JaxStore(cap, policy, block_tokens=BT)
    port = TorchStore(cap, policy, block_tokens=BT)
    ref_ev, ref_lk = _drive(ref, seed=3)
    port_ev, port_lk = _drive(port, seed=3)
    assert ref.evictions > 0, "op stream produced no pressure"
    assert port.eviction_log == ref.eviction_log
    assert port_ev == ref_ev
    assert port_lk == ref_lk
    assert port.state.ref_count == ref.state.ref_count
    assert port.state.eff_ref_count == ref.state.eff_ref_count
    assert port.metrics() == ref.metrics()
