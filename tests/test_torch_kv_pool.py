"""The port's paged-KV allocator (kubedl_tpu_torch/serving/kv_pool.py):
tests/test_kv_pool.py's ten cases, each run on the port AND on the JAX
package's `BlockPool`/`PrefixIndex` with the same sequence of operations,
every observation logged (block ids, refcounts, `stats()`, hit counts,
raised errors) and the two logs held equal; plus a seeded churn of random
operations crossed the same way and the device pool's layout."""
import numpy as np
import pytest
import torch

from kubedl_tpu.serving import kv_pool as jkv
from kubedl_tpu_torch.models.llama import LlamaConfig
from kubedl_tpu_torch.serving import kv_pool as tkv


class Log(list):
    """What a case observed, in order."""

    def pool(self, pool):
        self.append(("stats", pool.stats(),
                     [pool.refcount(b) for b in range(pool.num_blocks)]))

    def raises(self, exc, fn, *a, match=None):
        with pytest.raises(exc, match=match) as e:
            fn(*a)
        self.append(("raised", exc.__name__, str(e.value)))


def case_alloc_free_conservation(m, log):
    pool = m.BlockPool(num_blocks=8, block_size=4)
    assert pool.blocks_in_use == 1  # trash block is pinned
    a = pool.alloc(3)
    b = pool.alloc(2)
    log += [a, b]
    assert pool.blocks_in_use == 6 and pool.blocks_free + pool.blocks_in_use == 8
    assert len(set(a) | set(b)) == 5 and 0 not in a + b
    pool.free(a)
    assert pool.blocks_in_use == 3
    log.pool(pool)


def case_double_free_raises(m, log):
    pool = m.BlockPool(num_blocks=4, block_size=4)
    a = pool.alloc(1)
    pool.free(a)
    log.raises(ValueError, pool.free, a, match="double free")
    log.raises(ValueError, pool.free, [0], match="trash")
    log.raises(ValueError, m.BlockPool, 1, 4, match="trash")
    log.pool(pool)


def case_alloc_all_or_nothing(m, log):
    pool = m.BlockPool(num_blocks=4, block_size=4)
    log.append(pool.alloc(2))
    free_before = pool.blocks_free
    log.raises(m.PoolExhausted, pool.alloc, free_before + 1)
    assert pool.blocks_free == free_before  # no partial grant leaks
    log.pool(pool)


def case_refcounted_sharing(m, log):
    pool = m.BlockPool(num_blocks=4, block_size=4)
    [b] = pool.alloc(1)
    pool.incref([b])
    pool.free([b])
    assert pool.refcount(b) == 1 and pool.blocks_in_use == 2
    log.pool(pool)
    pool.free([b])
    assert pool.refcount(b) == 0 and pool.blocks_in_use == 1
    log.raises(ValueError, pool.incref, [b], match="free block")
    log.pool(pool)


def case_copy_on_write(m, log):
    pool = m.BlockPool(num_blocks=6, block_size=4)
    [b] = pool.alloc(1)
    same, copied = pool.writable(b)
    assert same == b and not copied
    pool.incref([b])
    new, copied = pool.writable(b)
    assert copied and new != b and pool.refcount(new) == 1 and pool.cow_copies == 1
    log.append((b, new))
    [c] = pool.alloc(1)
    pool.free([c])
    log.raises(ValueError, pool.writable, c, match="free block")
    log.append(pool.writable(0))  # the trash block is never written in place
    log.pool(pool)


def case_fragmentation_bound_under_churn(m, log):
    rng = np.random.default_rng(0)
    pool = m.BlockPool(num_blocks=32, block_size=8)
    held = []
    for _ in range(300):
        if held and rng.random() < 0.5:
            pool.free(held.pop(rng.integers(len(held))))
        else:
            n = int(rng.integers(1, 5))
            if n <= pool.blocks_free:
                held.append(pool.alloc(n))
        assert pool.blocks_free + pool.blocks_in_use == 32
    log.append([list(h) for h in held])
    for v in held:
        pool.free(v)
    assert pool.blocks_in_use == 1
    got = pool.alloc(pool.blocks_free)
    assert len(got) == 31
    log.append(got)
    log.pool(pool)


def case_prefix_index_match_and_cap(m, log):
    pool = m.BlockPool(num_blocks=16, block_size=4)
    idx = m.PrefixIndex(pool)
    prompt = np.arange(1, 13, dtype=np.int32)  # 3 full blocks
    table = pool.alloc(3)
    assert idx.insert(prompt, table) == 3
    mt = idx.match(prompt)
    assert mt == table[:2]  # one token is left for the prefill
    assert all(pool.refcount(b) == 3 for b in mt)
    pool.free(mt)
    longer = np.concatenate([prompt, np.asarray([7, 8, 9], np.int32)])
    m2 = idx.match(longer)
    assert m2 == table
    pool.free(m2)
    div = prompt.copy()
    div[5] = 99
    m3 = idx.match(div)
    assert m3 == table[:1]
    pool.free(m3)
    assert idx.hit_rate() > 0
    log += [table, mt, m2, m3, idx.stats(), len(idx)]
    log.pool(pool)


def case_prefix_index_lru_release(m, log):
    pool = m.BlockPool(num_blocks=8, block_size=2)
    idx = m.PrefixIndex(pool)
    p1 = np.asarray([1, 2, 3, 4], np.int32)
    p2 = np.asarray([5, 6, 7, 8], np.int32)
    t1, t2 = pool.alloc(2), pool.alloc(2)
    idx.insert(p1, t1)
    idx.insert(p2, t2)
    pool.free(t1)
    pool.free(t2)
    assert pool.blocks_in_use == 5
    idx.match(p2)
    pool.free(idx.match(p2) or [])
    assert idx.release_lru(2) == 2
    assert len(idx) == 2
    assert idx.match(p1) == []
    log += [t1, t2, idx.stats()]
    log.pool(pool)


def case_index_eviction_never_breaks_live_tables(m, log):
    pool = m.BlockPool(num_blocks=8, block_size=2)
    idx = m.PrefixIndex(pool)
    prompt = np.asarray([1, 2, 3, 4, 5], np.int32)
    table = pool.alloc(3)
    idx.insert(prompt, table)
    assert idx.release_lru(10) == 0 and len(idx) == 2
    log.pool(pool)
    pool.free(table)
    assert pool.blocks_in_use == 3
    assert idx.release_lru(10) == 2
    assert len(idx) == 0 and pool.blocks_in_use == 1
    log += [table, idx.stats()]
    log.pool(pool)


def case_table_to_rows(m, log):
    rows = m.table_to_rows([3, 1], block_size=4, max_len=16)
    assert rows.shape == (16,) and rows.dtype == np.int32
    assert list(rows[:4]) == [12, 13, 14, 15] and list(rows[4:8]) == [4, 5, 6, 7]
    assert all(r == 0 for r in rows[8:])
    log.append(rows.tolist())
    log.append(m.table_to_rows([2, 5, 1], block_size=4, max_len=10, trash_row=3).tolist())


CASES = [case_alloc_free_conservation, case_double_free_raises,
         case_alloc_all_or_nothing, case_refcounted_sharing, case_copy_on_write,
         case_fragmentation_bound_under_churn, case_prefix_index_match_and_cap,
         case_prefix_index_lru_release, case_index_eviction_never_breaks_live_tables,
         case_table_to_rows]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_case_matches_jax(case):
    got, want = Log(), Log()
    case(tkv, got)
    case(jkv, want)
    assert got == want


def _churn(m, seed: int):
    """A seeded random mix of every allocator and index operation; the
    log of what each returned."""
    rng = np.random.default_rng(seed)
    pool = m.BlockPool(num_blocks=24, block_size=4)
    idx = m.PrefixIndex(pool)
    prompts = [rng.integers(1, 6, size=int(rng.integers(3, 20))).astype(np.int32)
               for _ in range(6)]
    tables, log = [], Log()
    for _ in range(200):
        op = int(rng.integers(6))
        try:
            if op == 0:
                p = prompts[int(rng.integers(len(prompts)))]
                t = idx.match(p)
                t = t + pool.alloc(-(-len(p) // 4) - len(t))
                idx.insert(p, t)
                tables.append(t)
                log.append(("admit", t))
            elif op == 1 and tables:
                pool.free(tables.pop(int(rng.integers(len(tables)))))
            elif op == 2 and tables:
                t = tables[int(rng.integers(len(tables)))]
                log.append(("cow", pool.writable(t[-1])))
            elif op == 3:
                log.append(("lru", idx.release_lru(int(rng.integers(1, 4)))))
            elif op == 4:
                log.append(("alloc", pool.alloc(int(rng.integers(1, 4)))))
            else:
                log.append(("index", idx.stats(), len(idx)))
        except m.PoolExhausted as e:
            log.append(("exhausted", str(e)))
        log.pool(pool)
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_churn_matches_jax(seed):
    assert _churn(tkv, seed) == _churn(jkv, seed)


def test_device_pool_layout():
    cfg = LlamaConfig.tiny(dtype=torch.bfloat16)
    pages = tkv.init_device_pool(cfg, num_blocks=5, block_size=4, device="cpu")
    assert len(pages["k"]) == len(pages["v"]) == cfg.n_layers
    for t in pages["k"] + pages["v"]:
        assert t.shape == (20, cfg.n_kv_heads, cfg.head_dim)
        assert t.dtype == torch.bfloat16 and t.device.type == "cpu" and not t.any()
