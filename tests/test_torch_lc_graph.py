"""The loop-closure mini-solve batch as one CUDA graph
(:func:`diasss_tpu_torch.solvers.lc._solve_batch`).

On the CPU: the graph path's padding (rows up to a power of two, the last
row repeated) and slicing give the unpadded eager solve's real rows bit for
bit; the graph key tells every input shape, dtype, device, bin-count kind
and value and configuration apart; the cache drops its least recently used
graph; the triangular solves the LM now takes give ``torch.cholesky_solve``'s
bits; a CPU pass counts no graph.  On the card (marked ``cuda``, skipped
without one): a replay equals the eager solve at the padded shape bit for
bit, a second survey's inputs under a captured key give that survey's
answer, three calls on one key give one capture and three replays, a
returned result outlives later replays, a pipeline pass counts its
capture and replays, and the ``lc.graph`` span gives the rows and LM trips
a replay runs.

This file imports no JAX; on a GPU machine without it, skip the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_lc_graph.py
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from diasss_tpu_torch import pipeline, trace
from diasss_tpu_torch.config import LoopClosureConfig, PipelineConfig
from diasss_tpu_torch.frame import build_keyframes_batch
from diasss_tpu_torch.solvers import lc
from diasss_tpu_torch.solvers.lm import cholesky_solve_or_nan
from diasss_tpu_torch.synthetic import make_survey

CFG = PipelineConfig()
KP, LCC = CFG.kp_noise, CFG.loop_closure
SHORT = LoopClosureConfig(max_lm_iters=8)  # a shorter LM keeps the CPU tests fast


def survey_items(seed, n_lines=3):
    s = make_survey(n_lines=n_lines, n_pings=100, n_bins=256, n_landmarks=40, seed=seed)
    items = [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in s.lines]
    return items, [l.gt_poses for l in s.lines]


def lc_inputs(seed, device):
    """``_solve_batch``'s tensor arguments for a toy survey's stacked batch,
    gathered as ``loop_closing_tfs_stacked`` gathers them (the bin counts a
    tensor, one per row)."""
    frames = build_keyframes_batch(survey_items(seed)[0], device=device)
    pair_ids = pipeline._overlap_pairs(frames, CFG.min_overlap)
    kps, cap = pipeline._assemble_pairs(frames, None, pair_ids, CFG, True)
    rows = torch.as_tensor(np.concatenate([kps[k].pairs for k in pair_ids]), device=device)
    sf = torch.as_tensor(np.concatenate([np.full(cap, i) for i, _ in pair_ids]), device=device)
    tf = torch.as_tensor(np.concatenate([np.full(cap, j) for _, j in pair_ids]), device=device)
    dr = pipeline._stack_padded([f.dr_poses for f in frames])
    geo = pipeline._stack_padded([f.geo for f in frames])
    alts = pipeline._stack_padded([f.altitudes for f in frames])
    gras, n_bins = pipeline._stack_tables(frames)
    id_s, id_t = rows[:, 0].long(), rows[:, 3].long()
    bin_s, bin_t = rows[:, 1].long(), rows[:, 4].long()
    return (rows, dr[sf, id_s], dr[tf, id_t], geo[sf, id_s, bin_s], geo[tf, id_t, bin_t], alts[sf, id_s],
            alts[tf, id_t], gras[tf], n_bins[sf])


def host_bits(tree):
    return [a.detach().cpu().contiguous().numpy().view(np.uint8) for a in pytree.tree_leaves(tree)]


def assert_bits_equal(a, b):
    la, lb = host_bits(a), host_bits(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def cpu_inputs():
    return lc_inputs(7, "cpu")


# --- CPU ---------------------------------------------------------------


@pytest.mark.parametrize("k,want", [(1, 1), (2, 2), (3, 4), (76, 128), (128, 128), (152, 256)])
def test_padded_rows_is_the_next_power_of_two(k, want):
    assert lc.padded_rows(k) == want


@pytest.mark.parametrize("bins", ["tensor", "int"])
@pytest.mark.parametrize("k", [1, 5, 11])
def test_padding_and_slicing_keep_the_real_rows_bit_for_bit(cpu_inputs, k, bins):
    tensors = [t[:k] for t in cpu_inputs]
    if bins == "int":
        tensors, n_bins = tensors[:8], int(cpu_inputs[8][0])
    else:
        n_bins = None
    want = lc._solve_eager(*tensors[:8], n_bins if bins == "int" else tensors[8], KP, SHORT)
    padded = lc._static_inputs(tensors, lc.padded_rows(k))
    assert padded[0].shape[0] == lc.padded_rows(k)
    for p in padded:  # the padding repeats the last real row
        assert torch.equal(p[k:], p[k - 1:k].expand_as(p[k:]))
    out = lc._solve_eager(*padded[:8], n_bins if bins == "int" else padded[8], KP, SHORT)
    assert_bits_equal(lc._real_rows(out, k), want)


def _key(rows=128, G=128, dtype=torch.float32, device="meta", bins=None, kp=KP, cfg=LCC):
    tensors = [torch.empty((rows, 7), dtype=torch.float32, device=device),
               torch.empty((rows, 6), dtype=dtype, device=device),
               torch.empty((rows, G), dtype=dtype, device=device)]
    if bins is None:
        bins = torch.empty(rows, dtype=torch.int64, device=device)
    if isinstance(bins, torch.Tensor):
        tensors.append(bins)
    return lc._graph_key(rows, tensors, bins, kp, cfg)


def test_graph_key_tells_every_input_apart():
    base = _key()
    assert _key() == base and hash(_key()) == hash(base)
    others = {
        "padded rows": _key(rows=256),
        "G": _key(G=192),
        "dtype": _key(dtype=torch.float64),
        "device": _key(device="cpu"),
        "bin count kind": _key(bins=512),
        "bin-count tensor dtype": _key(bins=torch.empty(128, dtype=torch.int32, device="meta")),
        "keypoint noise": _key(kp=dataclasses.replace(KP, sigma_r=KP.sigma_r * 2)),
        "LC config": _key(cfg=dataclasses.replace(LCC, max_lm_iters=LCC.max_lm_iters + 1)),
    }
    for name, key in others.items():
        assert key != base, name
    assert _key(bins=512) != _key(bins=384)
    assert _key(bins=512) == _key(bins=512)
    assert len(set(others.values()) | {base}) == len(others) + 1


def test_graph_cache_drops_the_least_recently_used(monkeypatch):
    monkeypatch.setattr(lc, "_graphs", collections.OrderedDict())
    n = lc.GRAPH_CACHE_SIZE
    for key in range(n):
        lc._remember(key, lc._Graph(None, (), ()))
    assert lc._lookup(0) is not None  # 0 is now the most recent; 1 the least
    lc._remember(n, lc._Graph(None, (), ()))
    assert len(lc._graphs) == n
    assert lc._lookup(1) is None
    assert all(lc._lookup(key) is not None for key in [0, *range(2, n + 1)])
    lc._remember(n + 1, lc._Graph(None, (), ()))
    assert lc._lookup(0) is None and len(lc._graphs) == n


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_triangular_solves_give_cholesky_solve_bits(rhs):
    g = torch.Generator().manual_seed(3)
    M = torch.randn(64, 9, 12, generator=g)
    A = M @ M.mT
    A[5] = -A[5]  # a failed factorisation: NaN either way
    b = torch.randn(64, 9, generator=g) if rhs == "vector" else torch.eye(9)[:, :6].expand(64, 9, 6)
    plain = cholesky_solve_or_nan(A, b)
    tri = cholesky_solve_or_nan(A, b, triangular=True)
    assert torch.isnan(tri[5]).all() and not torch.isnan(tri[:5]).any()
    assert_bits_equal(tri, plain)


def test_cpu_pass_counts_no_graph():
    before = dict(lc.graph_counts)
    items, gt = survey_items(7)
    frames = build_keyframes_batch(items, device="cpu")
    res = pipeline.run_slam(frames, PipelineConfig(loop_closure=SHORT), gt_rows_list=gt, run_eval2=False)
    assert res.lc_results
    assert not [k for k in res.counters if k.startswith("lc_graph_")]
    assert lc.graph_counts == before and not lc._graphs


# --- the card ----------------------------------------------------------


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(lc, "_graphs", collections.OrderedDict())
    return torch.device("cuda", 0)


def _cut(inputs, k):
    return [t[:k] for t in inputs]


def _graph_solve(tensors):
    return lc._solve_batch(*tensors, KP, LCC)


def _eager_padded(tensors):
    padded = lc._static_inputs(tensors, lc.padded_rows(tensors[0].shape[0]))
    return lc._real_rows(lc._solve_eager(*padded, KP, LCC), tensors[0].shape[0])


@pytest.mark.cuda
def test_replay_equals_eager_at_the_padded_shape(cuda_device):
    inputs = lc_inputs(7, cuda_device)
    k = inputs[0].shape[0] - 3  # padding rows, not a power of two
    assert lc.padded_rows(k) != k
    tensors = _cut(inputs, k)
    first = _graph_solve(tensors)  # the capture, then a replay
    again = _graph_solve(tensors)
    want = _eager_padded(tensors)
    assert_bits_equal(first, want)
    assert_bits_equal(again, want)


@pytest.mark.cuda
def test_a_second_survey_under_a_captured_key_gets_its_own_answer(cuda_device):
    a, b = lc_inputs(7, cuda_device), lc_inputs(9, cuda_device)
    k = min(a[0].shape[0], b[0].shape[0]) - 1
    ta, tb = _cut(a, k), _cut(b, k)
    ra = _graph_solve(ta)
    captures = lc.graph_counts["captures"]
    rb = _graph_solve(tb)
    assert lc.graph_counts["captures"] == captures  # the same key
    assert_bits_equal(rb, _eager_padded(tb))
    assert not torch.equal(ra[0].t, rb[0].t)


@pytest.mark.cuda
def test_three_calls_on_one_key_capture_once_and_replay_three_times(cuda_device):
    tensors = lc_inputs(7, cuda_device)
    before = dict(lc.graph_counts)
    for _ in range(3):
        _graph_solve(tensors)
    assert lc.graph_counts["captures"] - before["captures"] == 1
    assert lc.graph_counts["replays"] - before["replays"] == 3
    assert len(lc._graphs) == 1


@pytest.mark.cuda
def test_a_returned_result_outlives_later_replays(cuda_device):
    a, b = lc_inputs(7, cuda_device), lc_inputs(9, cuda_device)
    k = min(a[0].shape[0], b[0].shape[0])
    first = _graph_solve(_cut(a, k))
    kept = host_bits(first)
    _graph_solve(_cut(b, k))
    _graph_solve(_cut(b, k))
    for x, y in zip(kept, host_bits(first)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_pipeline_pass_counts_its_capture_and_replays(cuda_device):
    items, gt = survey_items(7)
    counters = []
    for _ in range(2):
        frames = build_keyframes_batch(items, device=cuda_device)
        counters.append(pipeline.run_slam(frames, CFG, gt_rows_list=gt, run_eval2=False).counters)
    assert counters[0]["lc_graph_captures"] == 1 and counters[0]["lc_graph_replays"] == 1
    assert counters[1]["lc_graph_captures"] == 0 and counters[1]["lc_graph_replays"] == 1


@pytest.mark.cuda
def test_graph_span_says_what_a_replay_runs(cuda_device):
    tensors = lc_inputs(7, cuda_device)
    k = tensors[0].shape[0]
    with trace.recording() as rec:
        for _ in range(2):
            _graph_solve(tensors)
    spans = [s for s in rec.spans if s.name == "lc.graph"]
    assert [s.attrs["captured"] for s in spans] == [True, False]
    for s in spans:
        assert s.attrs["rows"] == k and s.attrs["rows_padded"] == lc.padded_rows(k)
        assert s.attrs["lm_iters"] == 2 * LCC.max_lm_iters
    assert not any(s.name.startswith("lm.") for s in rec.spans if s.start_ns >= spans[1].start_ns)
