"""The IVF index's life in reductive_tpu_torch.ivf against reductive_tpu.ivf
on the same arrays (CPU, ``use_kernel=False`` on both sides): the device
build (``placement="device"``) with its respill, ``ivf_add`` on its device
fast path and on the host path, and ``ivf_remove``.

Cell ids and codes are equal and cell norms within 1e-6 relative; the data
keeps every decision a build or an add makes more than 1e-4 relative from a
tie (asserted, as ``tests/test_torch_ivf.py`` does).  At ``capacity=None``
the device build is the port's host build bit for bit.
"""

import functools
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reductive_tpu import ivf as jivf
from reductive_tpu.pq.model import Pq as JPq
from reductive_tpu_torch import Pq, ivf

from test_torch_ivf import BUILD_SEED, assert_no_near_ties, j_index, model, stored
from torch_port_util import orthonormal, t

M, K = 2, 16
ADD_SEED = 31  # the rows ivf_add takes


def j_build(coarse, cb, x, projection=None, **kw):
    pq = JPq(codebooks=jnp.asarray(cb),
             projection=None if projection is None else jnp.asarray(projection))
    return jivf.build_ivf(jnp.asarray(coarse), pq, jnp.asarray(x), use_kernel=False, **kw)


def assert_same_index(index, j_idx):
    """Equal cell ids, codes and dropped ids, norms within 1e-6 relative."""
    np.testing.assert_array_equal(index.cell_ids.numpy(), np.asarray(j_idx.cell_ids))
    np.testing.assert_array_equal(index.cell_codes.numpy(), np.asarray(j_idx.cell_codes))
    np.testing.assert_allclose(index.cell_norms.numpy(), np.asarray(j_idx.cell_norms), rtol=1e-6)
    np.testing.assert_array_equal(index.dropped_ids, np.asarray(j_idx.dropped_ids))


def assert_bit_equal(a, b):
    for name in ("cell_ids", "cell_codes", "cell_norms"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    np.testing.assert_array_equal(a.dropped_ids, b.dropped_ids)


def stored_rows(index, x, ids=None):
    """The stored rows' vectors and cells: ``x`` holds the rows of the ids
    ``ids`` (``0 .. len(x) - 1`` where None); ids outside are skipped."""
    cells, _, rows = stored(index)
    ids = np.arange(len(x)) if ids is None else np.asarray(ids)
    pos = {int(i): p for p, i in enumerate(ids)}
    keep = np.array([int(r) in pos for r in rows], bool)
    return x[[pos[int(r)] for r in rows[keep]]], cells[keep]


# ---------------------------------------------------------------------------
# The device build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_unbounded_device_build_is_the_host_build(packed):
    x, coarse, cb = model(BUILD_SEED)
    args = (t(coarse), Pq(codebooks=t(cb)), t(x))
    dev = ivf.build_ivf(*args, placement="device", packed=packed, batch=128)
    host = ivf.build_ivf(*args, placement="host", packed=packed, batch=128)
    assert_bit_equal(dev, host)
    assert ivf.build_ivf(*args, packed=packed).cell_ids.equal(host.cell_ids)  # "auto" on the CPU
    assert_same_index(dev, j_build(coarse, cb, x, placement="device", packed=packed, batch=128))
    xr, cells = stored_rows(dev, x)
    assert_no_near_ties(xr, coarse, cb, cells, 1)
    assert dev.packed == packed and dev.capacity == int(np.bincount(cells).max())


BOUNDED = {
    "auto": dict(capacity="auto"),
    "int_spill": dict(capacity=50),
    "int_drop": dict(capacity=40, on_overflow="drop"),
    "auto_packed": dict(capacity="auto", packed=True),
}


@pytest.mark.parametrize("case", list(BOUNDED))
def test_bounded_device_build_matches_jax(case, caplog):
    x, coarse, cb = model(BUILD_SEED)
    kw = BOUNDED[case]
    with caplog.at_level(logging.INFO, logger="reductive_tpu"):
        index = ivf.build_ivf(t(coarse), Pq(codebooks=t(cb)), t(x), placement="device", batch=96,
                              **kw)
    assert_same_index(index, j_build(coarse, cb, x, placement="device", batch=96, **kw))
    xr, cells = stored_rows(index, x)
    assert_no_near_ties(xr, coarse, cb, cells, 1)
    # Every row once (or dropped); a row within its nearest cell's capacity sits there.
    _, _, rows = stored(index)
    assert sorted(rows.tolist() + index.dropped_ids.tolist()) == list(range(len(x)))
    assert (index.dropped_ids.size > 0) == (case == "int_drop")
    nearest = np.argmin(((x[:, None, :] - coarse[None]) ** 2).sum(-1), axis=1)
    within = np.bincount(nearest, minlength=len(coarse))[nearest[rows]] <= index.capacity
    assert (cells[within] == nearest[rows][within]).all()
    moved = bool((cells != nearest[rows]).any())
    assert moved or case not in ("int_spill",)
    stages = [r.args[0] for r in port_records(caplog, "IVF build pass")]
    assert stages == ["assign", "placement", "encode", "gather"] + ["spill"] * moved


def respill_model(seed, per_a=300, per_b=60, d=8):
    """Two groups of 20 cells far apart, each cell at its own distance from
    its group's centre, and rows packed at the two centres (near-identical
    rows share every decision): the group of 300 rows overflows its nearest
    cell and then its 16 nearest, which forces a redraw."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(d)
    a *= 40.0 / np.linalg.norm(a)
    dirs = rng.standard_normal((40, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = np.tile(1.0 + 0.5 * np.arange(20), 2)[:, None]
    coarse = np.concatenate([a + radii[:20] * dirs[:20], -a + radii[20:] * dirs[20:]])
    x = np.concatenate([a + 1e-4 * rng.standard_normal((per_a, d)),
                        -a + 1e-4 * rng.standard_normal((per_b, d))])
    cb = 0.3 * rng.standard_normal((M, K, d // M))
    return x.astype(np.float32), coarse.astype(np.float32), cb.astype(np.float32)


RESPILL_SEED = 11


@pytest.mark.parametrize("rounds", [64, 3])
def test_respill_redraws_and_host_spill_match_jax(monkeypatch, caplog, rounds):
    """The respill's rounds with a redraw (64 rounds, the default), and,
    with 3 rounds, rows left to the host's ``_spill_place``."""
    x, coarse, cb = respill_model(RESPILL_SEED)
    monkeypatch.setattr(ivf, "_respill_device", functools.partial(ivf._respill_device,
                                                                  rounds=rounds))
    monkeypatch.setattr(jivf, "_respill_device", functools.partial(jivf._respill_device,
                                                                   rounds=rounds))
    with caplog.at_level(logging.INFO, logger="reductive_tpu"):
        index = ivf.build_ivf(t(coarse), Pq(codebooks=t(cb)), t(x), capacity=10,
                              placement="device")
    assert_same_index(index, j_build(coarse, cb, x, capacity=10, placement="device"))
    xr, cells = stored_rows(index, x)
    assert_no_near_ties(xr, coarse, cb, cells, 1)
    (record,) = port_records(caplog, "IVF respill")
    placed, n_over, n_rounds, redraws, left = record.args
    assert n_over == 290 + 50 and placed + left == n_over
    if rounds == 64:
        assert left == 0 and redraws >= 1 and n_rounds > 16
    else:
        assert n_rounds == 3 and 0 < placed and left > 0
    assert index.dropped_ids.size == 0 and sorted(stored(index)[2].tolist()) == list(range(360))


def test_device_build_overflow_errors_match_jax():
    x, coarse, cb = model(BUILD_SEED)
    for kw, match in [(dict(capacity=40, on_overflow="error"), "nearest cell's capacity"),
                      (dict(capacity=10), "no spill placement")]:
        with pytest.raises(ValueError, match=match) as t_err:
            ivf.build_ivf(t(coarse), Pq(codebooks=t(cb)), t(x), placement="device", **kw)
        with pytest.raises(ValueError, match=match) as j_err:
            j_build(coarse, cb, x, placement="device", **kw)
        assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# ivf_add and ivf_remove
# ---------------------------------------------------------------------------


def base_index(capacity="auto", packed=False, seed=BUILD_SEED, **kw):
    x, coarse, cb = model(seed)
    index = ivf.build_ivf(t(coarse), Pq(codebooks=t(cb)), t(x), capacity=capacity, packed=packed,
                          **kw)
    return x, coarse, cb, index


def new_rows(seed, n, coarse):
    """``n`` rows near the cells' centroids, as ``clustered`` draws them."""
    rng = np.random.default_rng(seed)
    member = rng.integers(0, len(coarse), n)
    return (coarse[member] + 0.3 * rng.standard_normal((n, coarse.shape[1]))).astype(np.float32)


def near_full_cell(index, coarse, n, seed=ADD_SEED):
    """``n`` rows near the centroid of the index's fullest cell, and that cell."""
    full = int(np.argmax(np.bincount(stored(index)[0], minlength=len(coarse))))
    rng = np.random.default_rng(seed)
    return (coarse[full] + 0.3 * rng.standard_normal((n, coarse.shape[1]))).astype(np.float32), full


def test_scatter_updates_donated_is_copy_on_write_in_place():
    _, _, _, index = base_index()
    cc, ss = torch.tensor([0, 3], dtype=torch.int32), torch.tensor([1, 2], dtype=torch.int32)
    codes = torch.tensor([[1, 2], [3, 4]], dtype=torch.uint8)
    ids, norms = torch.tensor([7000, 7001]), torch.tensor([1.5, 2.5])
    before = [index.cell_codes.clone(), index.cell_ids.clone(), index.cell_norms.clone()]
    cow = ivf._scatter_updates(index.cell_codes, index.cell_ids, index.cell_norms, cc, ss, codes,
                               ids, norms)
    for got, was in zip((index.cell_codes, index.cell_ids, index.cell_norms), before):
        assert torch.equal(got, was)
    donated = ivf._scatter_updates(index.cell_codes, index.cell_ids, index.cell_norms, cc, ss,
                                   codes, ids, norms, donate=True)
    for d_t, c_t, given in zip(donated, cow, (index.cell_codes, index.cell_ids, index.cell_norms)):
        assert d_t is given and torch.equal(d_t, c_t)
    assert cow[1].dtype == torch.int32 and cow[1][3, 2] == 7001


def both_add(index, x_new, *, ids=None, **kw):
    """``ivf_add`` of the port and of the JAX package on the same index."""
    got = ivf.ivf_add(index, t(x_new), ids=ids, **kw)
    want = jivf.ivf_add(j_index(index), jnp.asarray(x_new), ids=ids, use_kernel=False, **kw)
    return got, want


def port_records(caplog, start):
    """The port's log records whose message starts with ``start`` (the JAX
    package logs under the same name)."""
    return [r for r in caplog.records
            if "reductive_tpu_torch" in r.pathname and r.msg.startswith(start)]


def paths(caplog):
    """The add paths the port logged at INFO."""
    return [r.msg.split(":")[0] for r in port_records(caplog, "IVF add")
            if r.levelno == logging.INFO]



def test_add_fast_path_matches_jax_and_the_host_path(monkeypatch, caplog):
    x, coarse, cb, index = base_index()
    index = ivf.ivf_remove(index, np.arange(0, len(x), 7))
    x_new = new_rows(ADD_SEED, 24, coarse)
    ids = np.arange(9000, 9024)
    with caplog.at_level(logging.INFO, logger="reductive_tpu"):
        fast, want = both_add(index, x_new, ids=ids)
        real_gate, j_gate = ivf._add_fast_gate, jivf._add_fast_gate
        monkeypatch.setattr(ivf, "_add_fast_gate", lambda cell_ids, assign, L: (
            torch.tensor(True), real_gate(cell_ids, assign, L)[1]))
        monkeypatch.setattr(jivf, "_add_fast_gate", lambda cell_ids, assign, L: (
            jnp.asarray(True), j_gate(cell_ids, assign, L)[1]))
        host, want_host = both_add(index, x_new, ids=ids)
    assert paths(caplog) == ["IVF add (device fast path)", "IVF add"]
    assert_same_index(fast, want)
    assert_same_index(host, want_host)
    assert_bit_equal(fast, host)
    xr, cells = stored_rows(fast, x_new, ids)
    assert_no_near_ties(xr, coarse, cb, cells, 1)


@pytest.mark.parametrize("on_overflow", ["spill", "drop"])
def test_add_overflow_path_matches_jax(on_overflow, caplog):
    """A full index (``capacity=None``: its largest cell is full) takes rows
    near its fullest cell: they go by the candidates, the spill or the
    drop."""
    x, coarse, cb, index = base_index(capacity=None)
    x_new, full = near_full_cell(index, coarse, 20)
    free = index.n_cells * index.capacity - len(x)
    if on_overflow == "drop":
        x_new = np.concatenate([x_new, new_rows(ADD_SEED + 1, free, coarse)])
    with caplog.at_level(logging.INFO, logger="reductive_tpu"):
        got, want = both_add(index, x_new, on_overflow=on_overflow)
    assert paths(caplog) == ["IVF add"]
    assert_same_index(got, want)
    ids = len(x) + np.arange(len(x_new))
    if on_overflow == "drop":
        assert got.dropped_ids.size >= len(x_new) - free
    else:
        assert got.dropped_ids.size == 0
    xr, cells = stored_rows(got, x_new, ids)
    assert_no_near_ties(xr, coarse, cb, cells, 4)
    _, new_cells = stored_rows(got, x_new[:20], ids[:20])
    assert (new_cells != full).all() and (len(new_cells) == 20 or on_overflow == "drop")


def test_add_errors_match_jax():
    x, coarse, _, index = base_index(capacity=None)
    x_new, _ = near_full_cell(index, coarse, 10)
    free = index.n_cells * index.capacity - len(x)
    cases = [
        (dict(on_overflow="error", overflow_candidates=1), x_new, "candidate cells"),
        (dict(), new_rows(ADD_SEED, free + 1, coarse), "total free capacity"),
        (dict(ids=np.arange(5)), x_new[:5], "already live"),
        (dict(ids=np.array([500, 500, 501])), x_new[:3], "duplicate ids"),
        (dict(ids=np.array([7, 2 ** 32])), x_new[:2], "int32"),
        (dict(ids=np.array([-3, 900])), x_new[:2], "non-negative"),
        (dict(ids=np.arange(3)), x_new[:2], "shape"),
    ]
    for kw, rows, match in cases:
        with pytest.raises(ValueError, match=match) as t_err:
            ivf.ivf_add(index, t(rows), **kw)
        with pytest.raises(ValueError, match=match) as j_err:
            jivf.ivf_add(j_index(index), jnp.asarray(rows), use_kernel=False, **kw)
        assert str(t_err.value) == str(j_err.value)


def test_add_default_and_explicit_ids():
    x, coarse, _, index = base_index()
    x_new = new_rows(ADD_SEED, 6, coarse)
    got, want = both_add(index, x_new)  # default: max(ids) + 1 + arange
    assert_same_index(got, want)
    assert sorted(stored(got)[2].tolist()) == list(range(len(x) + 6))
    top = ivf.ivf_add(index, t(x_new[:1]), ids=torch.tensor([2 ** 31 - 1]))
    assert int(top.cell_ids.max()) == 2 ** 31 - 1
    with pytest.raises(ValueError, match="auto-assigned ids would exceed int32") as t_err:
        ivf.ivf_add(top, t(x_new[1:3]))
    with pytest.raises(ValueError, match="auto-assigned") as j_err:
        jivf.ivf_add(j_index(top), jnp.asarray(x_new[1:3]), use_kernel=False)
    assert str(t_err.value) == str(j_err.value)
    empty = ivf.ivf_remove(index, np.arange(len(x)))
    assert int(empty.cell_ids.max()) == -1
    assert sorted(stored(ivf.ivf_add(empty, t(x_new)))[2].tolist()) == list(range(6))


class Reader:
    n, dim = 10, 8

    def read(self, start, count):
        return np.zeros((count, self.dim), np.float32)


def test_add_argument_errors():
    x, _, _, index = base_index()
    with pytest.raises(TypeError, match=r"rebuild with build_ivf\(reader\)"):
        ivf.ivf_add(index, Reader())
    with pytest.raises(ValueError, match="on_overflow"):
        ivf.ivf_add(index, t(x[:2]), on_overflow="panic")
    with pytest.raises(ValueError, match="instances lie on meta, the index on cpu"):
        ivf.ivf_add(index, torch.empty((2, x.shape[1]), device="meta"))
    with pytest.raises(ValueError, match=r"a tensor on the index's device \(cpu\), got ndarray"):
        ivf.ivf_add(index, x[:2])


def test_add_with_opq_residuals_matches_jax():
    x, coarse, cb = model(BUILD_SEED)
    proj = orthonormal(41, x.shape[1])
    pq = Pq(codebooks=t(cb), projection=t(proj))
    index = ivf.build_ivf(t(coarse), pq, t(x), capacity="auto")
    assert_same_index(index, j_build(coarse, cb, x, projection=proj, capacity="auto",
                                     placement="host"))
    x_new = new_rows(ADD_SEED, 12, coarse)
    got, want = both_add(index, x_new)
    assert_same_index(got, want)
    # Each stored code is the rotated residual's against its storage cell.
    cells, slots, rows = stored(got)
    new = rows >= len(x)
    res = t(x_new[rows[new] - len(x)]) - index.coarse_centroids[torch.from_numpy(cells[new])]
    assert torch.equal(got.cell_codes[torch.from_numpy(cells[new]), torch.from_numpy(slots[new])],
                       pq.quantize_batch(res))


def test_packed_index_add_and_remove_match_jax_and_unpacked():
    x, coarse, _, unpacked = base_index()
    _, _, _, packed = base_index(packed=True)
    gone = np.arange(0, len(x), 17)
    x_new = new_rows(ADD_SEED, 16, coarse)
    got, want = both_add(ivf.ivf_remove(packed, gone), x_new)
    assert got.packed and got.cell_codes.shape[2] == M // 2
    assert_same_index(got, want)
    plain = ivf.ivf_add(ivf.ivf_remove(unpacked, gone), t(x_new))
    assert torch.equal(got.cell_ids, plain.cell_ids)
    q = t(x_new[:5])
    for use_kernel in (False, True):
        a = ivf.ivf_search(plain, q, 5, nprobe=4, use_kernel=use_kernel)
        b = ivf.ivf_search(got, q, 5, nprobe=4, use_kernel=use_kernel)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_add_keeps_the_dropped_ids():
    x, coarse, _, index = base_index(capacity=40, on_overflow="drop", placement="device")
    before = index.dropped_ids.copy()
    assert before.size > 0
    live = stored(index)[2]
    freed = ivf.ivf_remove(index, live[:20])
    np.testing.assert_array_equal(freed.dropped_ids, before)
    got, want = both_add(freed, new_rows(ADD_SEED, 5, coarse))
    assert_same_index(got, want)
    np.testing.assert_array_equal(got.dropped_ids, before)
    # A drop in the add itself is appended.
    full = ivf.build_ivf(index.coarse_centroids, index.pq, t(x), capacity=None)
    over = new_rows(ADD_SEED + 2, full.n_cells * full.capacity - len(x) + 3, coarse)
    got, want = both_add(ivf.IvfPq(full.coarse_centroids, full.pq, full.cell_codes, full.cell_ids,
                                   full.cell_norms, dropped_ids=before),
                         over, on_overflow="drop")
    assert_same_index(got, want)
    assert got.dropped_ids.size >= before.size + 3
    np.testing.assert_array_equal(got.dropped_ids[:before.size], before)


@pytest.mark.parametrize("path", ["fast", "host"])
def test_donated_add_equals_copy_on_write(path, caplog):
    x, coarse, _, index = base_index(capacity=None)
    if path == "host":
        x_new = near_full_cell(index, coarse, 10)[0]
    else:  # room in every cell
        index = ivf.ivf_remove(index, np.arange(0, len(x), 4))
        x_new = new_rows(ADD_SEED, 10, coarse)
    ids = np.arange(5000, 5010)
    with caplog.at_level(logging.INFO, logger="reductive_tpu"):
        cow = ivf.ivf_add(index, t(x_new), ids=ids)
    assert paths(caplog) == ["IVF add (device fast path)" if path == "fast" else "IVF add"]
    was = index.cell_ids.clone()
    donated = ivf.ivf_add(index, t(x_new), ids=ids, donate=True)
    assert_bit_equal(donated, cow)
    assert donated.cell_codes is index.cell_codes and donated.cell_ids is index.cell_ids
    assert not torch.equal(was, index.cell_ids)  # the input's tensors took the rows


def test_remove_matches_jax_is_idempotent_and_shares_codes():
    x, _, _, index = base_index()
    gone = np.arange(0, len(x), 3)
    removed = ivf.ivf_remove(index, gone)
    want = jivf.ivf_remove(j_index(index), gone)
    assert_same_index(removed, want)
    assert removed.cell_codes is index.cell_codes and removed.cell_norms is index.cell_norms
    assert int((removed.cell_ids >= 0).sum()) == len(x) - len(gone)
    assert_bit_equal(ivf.ivf_remove(removed, gone), removed)
    assert_bit_equal(ivf.ivf_remove(removed, torch.from_numpy(gone)), removed)
    # Ids outside [0, 2^31) are ignored, not wrapped onto live ones.
    same = ivf.ivf_remove(index, np.array([2 ** 32, 2 ** 31, -5], dtype=np.int64))
    assert torch.equal(same.cell_ids, index.cell_ids)


def test_removed_slots_are_taken_again():
    x, coarse, _, index = base_index(capacity=None)
    gone = np.arange(0, len(x), 3)
    removed = ivf.ivf_remove(index, gone)
    x_new = new_rows(ADD_SEED, 60, coarse)
    got, want = both_add(removed, x_new)
    assert_same_index(got, want)
    assert got.capacity == index.capacity
    cells, slots, rows = stored(got)
    assert len(rows) == len(x) - len(gone) + 60 == len(set(zip(cells, slots)))
    assert not np.isin(rows[rows < len(x) - 1], gone).any()  # default ids start at 399 again


def test_search_after_remove_and_add_matches_jax():
    x, coarse, _, index = base_index(placement="device")
    j_idx = j_index(index)
    gone = np.arange(1, len(x), 5)
    x_a, x_b = new_rows(ADD_SEED, 20, coarse), new_rows(ADD_SEED + 3, 30, coarse)
    index = ivf.ivf_add(ivf.ivf_add(ivf.ivf_remove(index, gone), t(x_a)), t(x_b))
    j_idx = jivf.ivf_add(jivf.ivf_add(jivf.ivf_remove(j_idx, gone), jnp.asarray(x_a),
                                      use_kernel=False), jnp.asarray(x_b), use_kernel=False)
    assert_same_index(index, j_idx)
    rng = np.random.default_rng(9)
    q = np.concatenate([x_a[:4], x_b[:4], x[:4]])
    q = (q + 0.05 * rng.standard_normal(q.shape)).astype(np.float32)
    d, i = ivf.ivf_search(index, t(q), 6, nprobe=3)
    jd, ji = jivf.ivf_search(j_idx, jnp.asarray(q), 6, nprobe=3, use_kernel=False)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5 * float((q.astype(np.float64) ** 2).sum(1).max()))
    assert not np.isin(i.numpy(), gone).any()
