"""The port's page pool (a copy of flexflow_tpu/paged/pool.py with its
invariant checks copied in) held to the reference pool: the same random
operation sequence leaves both in the same state, and the port's local
invariant checks agree with the reference catalog's."""

import numpy as np
import pytest

pytest.importorskip("jax")

from flexflow_tpu.analysis import pool_invariants  # noqa: E402
from flexflow_tpu.paged.pool import PagePool as JPagePool  # noqa: E402
from flexflow_tpu_torch.paged.pool import EMPTY_HASH, PagePool  # noqa: E402


def _state(pool):
    return (sorted(pool._free), dict(pool._refs), list(pool._lru),
            dict(pool._full), dict(pool._partial),
            {p: list(k) for p, k in pool._keys_of.items()},
            pool.hits, pool.misses, pool.evictions, pool.hit_tokens)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_ops_match_reference(seed):
    rs = np.random.RandomState(seed)
    P = 4
    pools = [JPagePool(12, P, 6), PagePool(12, P, 6)]
    owners = [{}, {}]
    for step in range(60):
        op = rs.randint(4)
        toks = rs.randint(0, 3, size=rs.randint(1, 14)).astype(np.int32)
        outs = []
        for pool, own in zip(pools, owners):
            if op == 0:      # lookup + alloc the rest, as admission does
                pages, cached, cow = pool.lookup(toks)
                fresh = pool.alloc(pool.pages_for(len(toks)) - len(pages))
                if fresh is None:
                    pool.free(pages + ([cow] if cow else []))
                    outs.append(None)
                    continue
                if cow is not None:
                    pool.free([cow])
                own[step] = (pages + fresh, toks)
                outs.append((pages, cached, cow, fresh))
            elif op == 1 and own:  # publish + release the oldest owner
                key = min(own)
                pages, t = own.pop(key)
                chain = pool.chain_hashes(t)
                for p, h in zip(pages, chain):
                    pool.register_full(p, h)
                full = len(chain)
                if full < len(pages) and len(t) > full * P:
                    pool.register_partial(
                        pages[full], chain[-1] if chain else EMPTY_HASH,
                        t[full * P:])
                pool.free(list(reversed(pages)))
                outs.append(key)
            elif op == 2:
                perm, old_to_new = pool.defrag()
                outs.append(perm.tolist())
                for k, (pages, t) in own.items():
                    own[k] = ([int(old_to_new[p]) for p in pages], t)
            else:
                outs.append(pool.alloc(1))
                if outs[-1] is not None:
                    pool.free(outs[-1])
        assert outs[0] == outs[1], (step, op)
        assert _state(pools[0]) == _state(pools[1]), (step, op)
        live = {k: v[0] for k, v in owners[1].items()}
        pools[1].check_invariants(live)
        assert pool_invariants.check_pool(pools[1], live) == []


def test_port_invariant_checks_catch_corruption():
    pool = PagePool(8, 4, 4)
    pages = pool.alloc(2)
    pool._free.append(pages[0])  # a live page back on the free list
    with pytest.raises(AssertionError, match="free-accounting"):
        pool.check_invariants()
    assert pool_invariants.check_pool(pool)
