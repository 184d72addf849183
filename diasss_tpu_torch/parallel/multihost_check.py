"""Multi-process smoke check of the port's multi-device layer.

Counterpart of :mod:`diasss_tpu.parallel.multihost_check`.  Each process is
one rank (it owns one device; the JAX package's ``--local-devices`` has no
counterpart):

    # once per rank, on each host or several times on one machine:
    python -m diasss_tpu_torch.parallel.multihost_check \\
        --init-method tcp://HOST:PORT --world-size N --rank R \\
        [--backend nccl|gloo] [--device cpu|cuda|cuda:K]

Every rank builds the same synthetic problems and runs three phases over
the whole group, each held to the rank's own single-device solve:

1. ``MULTIHOST_OK`` — the sequence-parallel pose graph (halo exchanges and
   loop-closure gathers cross the process boundary);
2. ``MULTIHOST_BA_OK`` — sequence-parallel full BA: the owner-align
   ``all_to_all``, the routed target-pose exchanges and the reductions
   cross the boundary;
3. ``MULTIHOST_ELASTIC_OK`` — elastic recovery across the boundary: the
   solve starts on the whole group, then "the other ranks disappear"
   between chunks (an injected probe, the mechanism the heartbeat
   watchdog drives on a dead peer) and each rank continues alone from the
   carried state, landing on the uninterrupted optimum.

The device defaults to ``cuda:RANK`` (modulo the GPUs present) and the
backend to ``nccl``; without CUDA the check raises unless ``--device cpu``
is given, which takes ``gloo``.  ``nccl`` needs one GPU per rank; ranks
that share a GPU pass ``--backend gloo``.
"""

from __future__ import annotations

import argparse
import math
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("multihost_check")
    parser.add_argument("--init-method", required=True, help="tcp://HOST:PORT or file://PATH")
    parser.add_argument("--world-size", type=int, required=True)
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                        help="default nccl on the card, gloo with --device cpu")
    parser.add_argument("--device", default=None, help="this rank's device (default cuda:RANK; cpu only when given)")
    parser.add_argument("--pings", type=int, default=96)
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..config import FullBAConfig, KeypointNoiseConfig, PoseGraphConfig
    from ..geometry import se3
    from ..solvers.full_ba import BAProblem, solve_full_ba
    from ..solvers.pose_graph import build_chain_graph, solve_pose_graph
    from .distributed import _require_cuda, heartbeat, initialize
    from .recovery import elastic_seq_pose_graph_solve
    from .seq import seq_full_ba_solve, seq_pose_graph_solve
    from .shard import make_mesh

    if args.device is not None:
        device = torch.device(args.device)
    else:
        _require_cuda("--device cpu")
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
    backend = args.backend or ("gloo" if device.type == "cpu" else "nccl")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    initialize(args.init_method, args.world_size, args.rank, backend=backend)
    mesh = make_mesh(args.world_size, device=device)
    r = mesh.rank
    print(f"rank {r}/{mesh.size} ({backend}) on {device}", flush=True)
    beat = heartbeat(mesh)
    assert beat == mesh.size, f"heartbeat saw {beat} of {mesh.size} ranks"

    # the same problem on every rank (a fixed seed)
    P = args.pings
    rng = np.random.default_rng(7)
    gt = np.zeros((P, 6), np.float32)
    gt[:, 3] = np.arange(P) * 0.5
    dr = gt.copy()
    dr[:, 3] += np.cumsum(rng.normal(0, 0.03, P)).astype(np.float32)
    dr[:, 4] += np.cumsum(rng.normal(0, 0.03, P)).astype(np.float32)
    dr[0] = gt[0]
    gt_poses = se3.from_rodrigues_xyz(torch.as_tensor(gt, device=device))
    li = np.asarray([2, P // 3], np.int64)
    lj = np.asarray([P - 3, 2 * P // 3], np.int64)
    lc_meas = se3.between(gt_poses[torch.as_tensor(li, device=device)], gt_poses[torch.as_tensor(lj, device=device)])
    cfg = PoseGraphConfig()
    graph = build_chain_graph([dr], lc_i=li, lc_j=lj, lc_meas=lc_meas, lc_sigmas=np.full((2, 6), 0.05, np.float32),
                              lc_valid=np.ones(2, bool), cfg=cfg, device=device)

    poses_local, info_local = solve_pose_graph(graph, cfg)
    poses_dist, info_dist = seq_pose_graph_solve(mesh, graph, cfg)
    err = float((poses_dist.t - poses_local.t).abs().max())
    e_l, e_d = float(info_local.error), float(info_dist.error)
    print(f"rank {r}: max|dt|={err:.2e} error local/dist={e_l:.6f}/{e_d:.6f} ({info_dist.solver_kind})", flush=True)
    assert err < 1e-3, err
    assert abs(e_l - e_d) < 1e-3 * max(1.0, e_l), (e_l, e_d)
    print("MULTIHOST_OK", flush=True)

    # --- phase 2: sequence-parallel full BA across the process boundary ---
    Kba = 2 * 8
    kp_i = rng.integers(1, P // 2, Kba)
    kp_j = rng.integers(P // 2, P - 1, Kba)
    sr = np.float32(math.sqrt(12.0 ** 2 + 12.0 ** 2))
    lm0 = np.stack([dr[kp_i, 3] + 6.0, dr[kp_i, 4] + 6.0, np.full(Kba, -12.0)], axis=1).astype(np.float32)

    def up(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    prob = BAProblem(poses0=graph.poses0, odo_meas=graph.odo_meas, odo_sigmas=graph.odo_sigmas,
                     kp_i=up(kp_i, torch.int64), kp_j=up(kp_j, torch.int64), kp_sr_s=up(np.full(Kba, sr)),
                     kp_sr_t=up(np.full(Kba, sr)), kp_valid=up(np.ones(Kba, bool), torch.bool), lm0=up(lm0),
                     lm_prior=up(lm0), lm_prior_sigmas=up([50.0, 50.0, 1.5]))
    ba_cfg, kp_cfg = FullBAConfig(max_iters=8), KeypointNoiseConfig()
    poses_bl, lms_l, info_bl = solve_full_ba(prob, ba_cfg, kp_cfg)
    poses_bd, lms_d, info_bd = seq_full_ba_solve(mesh, prob, ba_cfg, kp_cfg)
    err_ba = float((poses_bd.t - poses_bl.t).abs().max())
    err_lm = float((lms_d - lms_l).abs().max())
    e_l, e_d = float(info_bl.error), float(info_bd.error)
    print(f"rank {r}: BA max|dt|={err_ba:.2e} max|dlm|={err_lm:.2e} error local/dist={e_l:.6f}/{e_d:.6f} "
          f"({info_bd.solver_kind})", flush=True)
    assert err_ba < 5e-3, err_ba
    assert err_lm < 5e-2, err_lm
    assert abs(e_l - e_d) < 1e-2 * max(1.0, e_l), (e_l, e_d)
    print("MULTIHOST_BA_OK", flush=True)

    # --- phase 3: elastic recovery across the process boundary ---
    me = mesh.ranks[r]

    def probe(chunk_idx: int, ranks: list) -> list:
        # chunk 0 on the whole group; from chunk 1 every rank continues alone
        return list(ranks) if chunk_idx == 0 else [me]

    poses_el, info_el, events = elastic_seq_pose_graph_solve(graph, cfg, chunk=3, mesh=mesh, probe=probe)
    err_el = float((poses_el.t - poses_local.t).abs().max())
    print(f"rank {r}: elastic max|dt|={err_el:.2e} events={events}", flush=True)
    assert events and events[0][1] == mesh.size and events[0][2] == 1, events
    assert err_el < 1e-3, err_el
    print("MULTIHOST_ELASTIC_OK", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
