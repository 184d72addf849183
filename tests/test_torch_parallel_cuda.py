"""The multi-device layer on the card: the NCCL transport with one rank
(every collective of ``diasss_tpu_torch.parallel.collectives`` against its
definition, a send to itself included), and two gloo ranks sharing
``cuda:0`` running the sequence-parallel pose graph, held to the
single-device solve on the card.  Skipped without a GPU.

This file imports no JAX; on a GPU machine without it, skip the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py
"""

import numpy as np
import pytest
import torch

from torch_parallel_helpers import run_ranks


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL and the ranks' CUDA tensors have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_nccl_one_rank_collectives(cuda_device, tmp_path):
    out = run_ranks(tmp_path, 1, ["collectives"], {"unused": 0}, backend="nccl", device="cuda:0")[0]
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for key in ("psum", "psum_ordered", "ppermute", "ppermute_partial", "broadcast"):
        want = x * np.float32(0.1) if key == "psum_ordered" else x
        np.testing.assert_array_equal(out[f"collectives/{key}"], want)
    np.testing.assert_array_equal(out["collectives/all_gather"], x[None])
    np.testing.assert_array_equal(out["collectives/ppermute_mask"], x > 12)
    np.testing.assert_array_equal(out["collectives/all_to_all"], np.arange(2)[None])


def _chain(P=200, seed=5):
    from diasss_tpu_torch.geometry import se3
    from diasss_tpu_torch.solvers.pose_graph import build_chain_graph

    rng = np.random.default_rng(seed)
    gt = np.zeros((P, 6), np.float32)
    gt[:, 3] = np.arange(P) * 0.5
    dr = gt.copy()
    dr[:, 4] += np.cumsum(rng.normal(0, 0.03, P)).astype(np.float32)
    li = np.arange(2, P - 60, 9)
    lj = li + 51
    poses = se3.from_rodrigues_xyz(torch.as_tensor(gt))
    meas = se3.between(poses[torch.as_tensor(li)], poses[torch.as_tensor(lj)])
    return build_chain_graph([dr], li, lj, meas, np.full((len(li), 6), 0.05, np.float32), np.ones(len(li), bool),
                             device="cpu")


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_seq_pose_graph(cuda_device, tmp_path):
    from torch.utils import _pytree as pytree

    from diasss_tpu_torch.config import PoseGraphConfig
    from diasss_tpu_torch.solvers.pose_graph import solve_pose_graph

    g = _chain()
    inp = {"pg_kinds": "direct,dense_seg", "pg_iters": 10,
           **{f"pg_{k}_R": getattr(g, k).R.numpy() for k in ("poses0", "odo_meas", "lc_meas")},
           **{f"pg_{k}_t": getattr(g, k).t.numpy() for k in ("poses0", "odo_meas", "lc_meas")},
           **{f"pg_{k}": getattr(g, k).numpy() for k in ("odo_sigmas", "lc_i", "lc_j", "lc_sigmas", "lc_valid")}}
    res = run_ranks(tmp_path, 2, ["seq_pg"], inp, backend="gloo", device="cuda:0")
    ref, _ = solve_pose_graph(pytree.tree_map(lambda a: a.to(cuda_device), g),
                              PoseGraphConfig(max_gn_iters=10, preconditioner="direct"))
    for out in res:
        assert str(out["seq_pg/direct_kind"]) == "sp_direct"
        np.testing.assert_allclose(out["seq_pg/direct_t"], ref.t.cpu().numpy(), rtol=0, atol=1e-3)
        np.testing.assert_allclose(out["seq_pg/dense_seg_t"], ref.t.cpu().numpy(), rtol=0, atol=2e-3)
        np.testing.assert_array_equal(out["seq_pg/direct_t"], res[0]["seq_pg/direct_t"])
