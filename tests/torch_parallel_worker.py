"""One rank of the port's parallel parity tests (not collected by pytest).

    python tests/torch_parallel_worker.py --rank R --world N --store FILE \\
        --inputs IN.npz --out DIR --jobs a,b,...

joins a gloo group over a ``FileStore`` (``file://FILE``), runs the named
jobs on the CPU with one thread, each on the arrays of ``IN.npz`` (the JAX
package's inputs, written by the test process), and writes every job's
results to ``DIR/rank{R}.npz`` (keys prefixed by the job's name).  It
imports only torch and the port: the test process compares the results
with the JAX package's own multi-device functions.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch
from torch.utils import _pytree as pytree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from diasss_tpu_torch.geometry import se3  # noqa: E402
from diasss_tpu_torch.solvers.full_ba import BAProblem  # noqa: E402
from diasss_tpu_torch.solvers.pose_graph import PoseGraph  # noqa: E402

JOBS = {}


def job(fn):
    JOBS[fn.__name__] = fn
    return fn


def T(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def pose(inp, key):
    return se3.Pose3(T(inp[key + "_R"]), T(inp[key + "_t"]))


def graph_from(inp, p="pg_"):
    return PoseGraph(poses0=pose(inp, p + "poses0"), odo_meas=pose(inp, p + "odo_meas"),
                     odo_sigmas=T(inp[p + "odo_sigmas"]), lc_i=T(inp[p + "lc_i"], torch.int64),
                     lc_j=T(inp[p + "lc_j"], torch.int64), lc_meas=pose(inp, p + "lc_meas"),
                     lc_sigmas=T(inp[p + "lc_sigmas"]), lc_valid=T(inp[p + "lc_valid"], torch.bool))


def ba_from(inp, p="ba_"):
    return BAProblem(poses0=pose(inp, p + "poses0"), odo_meas=pose(inp, p + "odo_meas"),
                     odo_sigmas=T(inp[p + "odo_sigmas"]), kp_i=T(inp[p + "kp_i"], torch.int64),
                     kp_j=T(inp[p + "kp_j"], torch.int64), kp_sr_s=T(inp[p + "kp_sr_s"]),
                     kp_sr_t=T(inp[p + "kp_sr_t"]), kp_valid=T(inp[p + "kp_valid"], torch.bool),
                     lm0=T(inp[p + "lm0"]), lm_prior=T(inp[p + "lm_prior"]),
                     lm_prior_sigmas=T(inp[p + "lm_prior_sigmas"]))


# --------------------------------------------------------------------------
# collectives, reshard, ring, heartbeat
# --------------------------------------------------------------------------


@job
def collectives(mesh, inp):
    from diasss_tpu_torch.parallel import collectives as C

    n, r, dev = mesh.size, mesh.rank, mesh.device
    x = torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3) + 10 * r
    a2a = torch.arange(n * 2, dtype=torch.int64, device=dev).reshape(n, 2) + 100 * r
    ring = [(i, (i + 1) % n) for i in range(n)]
    out = {
        "psum": C.psum(mesh, x),
        "psum_ordered": C.psum_ordered(mesh, x * 0.1),
        "all_gather": C.all_gather(mesh, x),
        "ppermute": C.ppermute(mesh, [x, x > 12], ring)[0],
        "ppermute_mask": C.ppermute(mesh, [x, x > 12], ring)[1],
        "ppermute_partial": C.ppermute(mesh, [x], [(0, n - 1)])[0],
        "all_to_all": C.all_to_all(mesh, a2a),
        "broadcast": C.broadcast(mesh, x, src=n - 1),
    }
    assert all(v.device == dev for v in out.values())
    return {k: v.cpu().numpy() for k, v in out.items()}


@job
def reshard(mesh, inp):
    from diasss_tpu_torch.parallel.alltoall import reshard_rows

    out = {}
    for case in str(inp["reshard_cases"]).split(","):
        seed, k = (int(v) for v in case.split(":"))
        dest, valid = T(inp[f"reshard_{case}_dest"], torch.int64), T(inp[f"reshard_{case}_valid"], torch.bool)
        cap = int(inp[f"reshard_{case}_capacity"])
        tree, vout, dropped = reshard_rows(mesh, {"key": torch.arange(k)}, dest, valid, capacity=cap)
        out[f"{case}_key"] = tree["key"].numpy()
        out[f"{case}_valid"] = vout.numpy()
        out[f"{case}_dropped"] = np.asarray(dropped)
    return out


@job
def ring(mesh, inp):
    from diasss_tpu_torch.config import MatcherConfig
    from diasss_tpu_torch.matching.geosearch import geo_nn_search
    from diasss_tpu_torch.parallel.ring import ring_geo_nn_search

    out = {}
    for metric in str(inp["ring_metrics"]).split(","):
        args = [T(inp[f"ring_{metric}_{k}"]) for k in ("gq", "dq", "vq", "gr", "dr", "vr", "bbox")]
        args[2], args[5] = args[2].bool(), args[5].bool()
        cfg = MatcherConfig(**{k[len(f"ringcfg_{metric}_"):]: (str(v) if v.dtype.kind == "U" else float(v))
                               for k, v in inp.items() if k.startswith(f"ringcfg_{metric}_")})
        flip = bool(inp[f"ring_{metric}_flip"])
        res = ring_geo_nn_search(*args, cfg, flip, mesh)
        ref = geo_nn_search(*args, cfg, flip)
        out[f"{metric}_corres"] = res.corres.numpy()
        out[f"{metric}_ncand"] = res.n_candidates.numpy()
        out[f"{metric}_single_corres"] = ref.corres.numpy()
        out[f"{metric}_single_ncand"] = ref.n_candidates.numpy()
    return out


@job
def heartbeat(mesh, inp):
    from diasss_tpu_torch.parallel.distributed import heartbeat as beat, replica_divergence

    same = torch.arange(5, dtype=torch.float32)
    differ = same + 0.5 * mesh.rank
    return {"count": np.asarray(beat(mesh)), "div_same": np.asarray(replica_divergence({"a": same}, mesh)),
            "div_differ": np.asarray(replica_divergence([same, differ], mesh))}


# --------------------------------------------------------------------------
# sequence-parallel solvers
# --------------------------------------------------------------------------


@job
def seq_pg(mesh, inp):
    from diasss_tpu_torch.config import PoseGraphConfig
    from diasss_tpu_torch.parallel.seq import seq_pose_graph_solve
    from diasss_tpu_torch.solvers.pose_graph import solve_pose_graph

    g = pytree.tree_map(lambda a: a.to(mesh.device), graph_from(inp))
    out = {}
    for kind in str(inp["pg_kinds"]).split(","):
        cfg = PoseGraphConfig(max_gn_iters=int(inp["pg_iters"]), preconditioner=kind)
        poses, info = seq_pose_graph_solve(mesh, g, cfg)
        one_trial = dataclasses.replace(cfg, max_gn_iters=1)
        out.update({f"{kind}_t": poses.t.cpu().numpy(), f"{kind}_R": poses.R.cpu().numpy(),
                    f"{kind}_error": np.asarray(float(info.error)), f"{kind}_iters": np.asarray(info.iterations),
                    f"{kind}_cg": np.asarray(info.cg_iters_total), f"{kind}_kind": np.asarray(info.solver_kind),
                    f"{kind}_grad_norm": np.asarray(float(info.grad_norm)),
                    f"{kind}_grad_norm_1": np.asarray(float(seq_pose_graph_solve(mesh, g, one_trial)[1].grad_norm)),
                    f"{kind}_single_grad_norm_1": np.asarray(float(solve_pose_graph(g, one_trial)[1].grad_norm))})
    return out


@job
def seq_ba(mesh, inp):
    from diasss_tpu_torch.config import FullBAConfig, KeypointNoiseConfig
    from diasss_tpu_torch.parallel.seq import seq_full_ba_solve
    from diasss_tpu_torch.solvers.full_ba import solve_full_ba

    prob = ba_from(inp)
    out = {}
    for kind in str(inp["ba_kinds"]).split(","):
        cfg = FullBAConfig(max_iters=int(inp["ba_iters"]), preconditioner=kind)
        poses, lms, info = seq_full_ba_solve(mesh, prob, cfg, KeypointNoiseConfig())
        out.update({f"{kind}_t": poses.t.numpy(), f"{kind}_lms": lms.numpy(),
                    f"{kind}_error": np.asarray(float(info.error)), f"{kind}_cg": np.asarray(info.cg_iters_total),
                    f"{kind}_kind": np.asarray(info.solver_kind)})
        if kind == "direct" and mesh.rank == 0:
            p1, l1, i1 = solve_full_ba(prob, cfg, KeypointNoiseConfig())
            out.update({"single_direct_t": p1.t.numpy(), "single_direct_lms": l1.numpy(),
                        "single_direct_error": np.asarray(float(i1.error))})
    return out


@job
def sharded(mesh, inp):
    """The data-parallel solves against their single-device solves on the
    same rank: the LC mini-solves, the pose graph (LC batch sharded) and
    full BA (correspondence axis sharded)."""
    from diasss_tpu_torch.config import FullBAConfig, KeypointNoiseConfig, LoopClosureConfig, PoseGraphConfig
    from diasss_tpu_torch.parallel.shard import sharded_full_ba_solve, sharded_lc_solve, sharded_pose_graph_solve
    from diasss_tpu_torch.solvers.full_ba import solve_full_ba
    from diasss_tpu_torch.solvers.lc import loop_closing_tfs
    from diasss_tpu_torch.solvers.pose_graph import solve_pose_graph

    lc_args = [T(inp[f"lc_{k}"]) for k in ("pairs", "valid", "dr_s", "dr_t", "geo_s", "geo_t", "alts_s", "alts_t",
                                          "gras_t")]
    lc_args[1] = lc_args[1].bool()
    lc_cfg = LoopClosureConfig(max_lm_iters=10)
    lc = sharded_lc_solve(mesh, *lc_args, n_bins=int(inp["lc_n_bins"]), cfg=lc_cfg)
    lc1 = loop_closing_tfs(*lc_args, n_bins=int(inp["lc_n_bins"]), cfg=lc_cfg)
    g = graph_from(inp)
    pg_cfg = PoseGraphConfig(max_gn_iters=int(inp["pg_iters"]), preconditioner="direct")
    pg, pg_info = sharded_pose_graph_solve(mesh, g, pg_cfg)
    pg1, pg1_info = solve_pose_graph(g, pg_cfg)
    prob = ba_from(inp)
    ba_cfg = FullBAConfig(max_iters=int(inp["ba_iters"]), preconditioner="direct")
    ba, ba_lms, ba_info = sharded_full_ba_solve(mesh, prob, ba_cfg, KeypointNoiseConfig())
    ba1, ba1_lms, _ = solve_full_ba(prob, ba_cfg, KeypointNoiseConfig())
    return {"lc_quality": lc.quality.numpy(), "lc_t": lc.rel_pose.t.numpy(), "lc_single_quality": lc1.quality.numpy(),
            "lc_single_t": lc1.rel_pose.t.numpy(), "pg_t": pg.t.numpy(), "pg_single_t": pg1.t.numpy(),
            "pg_error": np.asarray(float(pg_info.error)), "pg_single_error": np.asarray(float(pg1_info.error)),
            "ba_t": ba.t.numpy(), "ba_single_t": ba1.t.numpy(), "ba_lms": ba_lms.numpy(),
            "ba_single_lms": ba1_lms.numpy()}


# --------------------------------------------------------------------------
# pipeline, online stream, elastic recovery
# --------------------------------------------------------------------------


class ReplayRng:
    """The JAX package's initial-noise draws, replayed (the rank processes
    import no JAX): ``normal`` returns the saved (P, 6) array."""

    def __init__(self, normal: np.ndarray):
        self._normal = normal

    def normal(self, shape):
        return torch.as_tensor(self._normal[: shape[0]]).reshape(tuple(shape))

    def categorical_matched(self, matched_mask, n_hyp, n_samples):
        raise AssertionError("no SCC draws on the annotation and dense paths")


def _pipeline_cfg(inp, name):
    """The port's config ``name`` of the pipeline parity test (the JAX side
    builds the same from its own package)."""
    from diasss_tpu_torch.config import FullBAConfig, PipelineConfig, PoseGraphConfig, automatic_config

    n = int(inp["mesh_devices"])
    if name == "two_stage":
        return PipelineConfig(pose_graph=PoseGraphConfig(preconditioner="tridiag"), mesh_devices=n)
    if name == "full_ba":
        return PipelineConfig(min_overlap=0.1, estimator="full_ba", full_ba=FullBAConfig(preconditioner="tridiag"),
                              mesh_devices=n)
    auto = automatic_config()
    return dataclasses.replace(auto, detector=dataclasses.replace(auto.detector, n_features=int(inp["auto_kps"])),
                               full_ba=dataclasses.replace(auto.full_ba, preconditioner="tridiag"),
                               rematch_iters=int(inp["auto_rematch"]), rematch_stop_resid_cells=0.0, mesh_devices=n)


@job
def pipeline(mesh, inp):
    from diasss_tpu_torch.pipeline import run_slam

    frames = torch.load(str(inp["frames_path"]), weights_only=False)
    feats = torch.load(str(inp["feats_path"]), weights_only=False)
    gt = [inp[f"gt_{k}"] for k in range(len(frames))]
    out = {}
    for name in str(inp["pipeline_names"]).split(","):
        cfg = _pipeline_cfg(inp, name)
        res = run_slam(frames, cfg, gt_rows_list=gt, run_eval2=False, rng=ReplayRng(inp["noise"]),
                       feats=feats if name == "auto" else None)
        out.update({f"{name}_ate_est": np.asarray(res.ate_est), f"{name}_ate_dr": np.asarray(res.ate_dr),
                    f"{name}_t": res.poses.t.numpy(), f"{name}_n_lc": np.asarray(res.n_lc_accepted),
                    f"{name}_pairs": np.asarray(res.pair_ids), f"{name}_counters": np.asarray(str(res.counters))})
    return out


@job
def slam(mesh, inp):
    """``run_slam`` of a saved port config on saved keyframes."""
    from diasss_tpu_torch.pipeline import run_slam

    frames = torch.load(str(inp["frames_path"]), weights_only=False)
    cfg = torch.load(str(inp["cfg_path"]), weights_only=False)
    gt = [inp[f"gt_{k}"] for k in range(len(frames))]
    res = run_slam(frames, cfg, gt_rows_list=gt, rng=ReplayRng(inp["noise"]))
    return {"t": res.poses.t.numpy(), "ate_est": np.asarray(res.ate_est), "n_lc": np.asarray(res.n_lc_accepted),
            "counters": np.asarray(str(res.counters))}


@job
def matchers(mesh, inp):
    """The data-parallel matchers against their single-device paths on the
    same rank: the stacked keypoint matcher and the dense matcher."""
    from diasss_tpu_torch.config import DenseMatchConfig, DetectorConfig, MatcherConfig
    from diasss_tpu_torch.features import attach_geo_patch_descriptors_batch
    from diasss_tpu_torch.matching.dense import dense_matching_stacked
    from diasss_tpu_torch.matching.robust import robust_matching, robust_matching_stacked
    from diasss_tpu_torch.rng import TorchRng

    frames = torch.load(str(inp["frames_path"]), weights_only=False)
    feats = torch.load(str(inp["feats_path"]), weights_only=False)
    pairs = [tuple(int(v) for v in p) for p in inp["match_pairs"]]
    img_ids = [f.img_id for f in frames]
    geo = [f.geo for f in frames]
    rows = [int(f.raw.shape[0]) for f in frames]
    det = DetectorConfig(descriptor="geo_patch")
    dense = dense_matching_stacked(pairs, img_ids, feats, [f.norm for f in frames], geo, det, DenseMatchConfig(),
                                   mesh=mesh)
    dense1 = dense_matching_stacked(pairs, img_ids, feats, [f.norm for f in frames], geo, det, DenseMatchConfig())
    mcfg = MatcherConfig(desc_metric="ncc", geo_radius=10.0, cross_check=True, scc_mode="xy")
    feats = attach_geo_patch_descriptors_batch(feats, [f.norm for f in frames], geo, det)
    kp = robust_matching_stacked(pairs, img_ids, feats, geo, rows, TorchRng(1, 0, "cpu"), mcfg, mesh=mesh)
    kp1 = robust_matching_stacked(pairs, img_ids, feats, geo, rows, TorchRng(1, 0, "cpu"), mcfg)
    i, j = pairs[0]
    ring = robust_matching(img_ids[i], img_ids[j], feats[i], feats[j], geo[i], geo[j], rows[i], rows[j],
                           TorchRng(1, 0, "cpu"), mcfg, mesh=mesh)
    ring1 = robust_matching(img_ids[i], img_ids[j], feats[i], feats[j], geo[i], geo[j], rows[i], rows[j],
                            TorchRng(1, 0, "cpu"), mcfg)
    out = {"ring_rows": ring.rows_s, "ring_single_rows": ring1.rows_s}
    for p in pairs:
        key = f"{p[0]}_{p[1]}"
        out.update({f"dense_{key}": dense[p][0], f"dense_single_{key}": dense1[p][0],
                    f"kp_{key}": kp[p].rows_s, f"kp_single_{key}": kp1[p].rows_s})
    return out


@job
def online(mesh, inp):
    from diasss_tpu_torch.config import FullBAConfig, PipelineConfig
    from diasss_tpu_torch.online import OnlineSlam

    frames = torch.load(str(inp["frames_path"]), weights_only=False)
    cfg = PipelineConfig(min_overlap=0.1, estimator="full_ba", full_ba=FullBAConfig(preconditioner="tridiag"),
                         mesh_devices=int(inp["mesh_devices"]))
    slam = OnlineSlam(cfg, window_frames=int(inp["online_window"]), device="cpu")
    out = {}
    for k, f in enumerate(frames):
        out[f"t{k}"] = slam.add_frame(f).t.numpy()
    out["kind"] = np.asarray(slam._last_info.solver_kind)
    return out


@job
def elastic(mesh, inp):
    from diasss_tpu_torch.config import PoseGraphConfig
    from diasss_tpu_torch.parallel.recovery import elastic_seq_pose_graph_solve, group_mesh
    from diasss_tpu_torch.parallel.seq import seq_pose_graph_solve
    from diasss_tpu_torch.solvers.pose_graph import solve_pose_graph

    g = graph_from(inp, "el_")
    cfg = PoseGraphConfig(init_noise_xyz=0.0, init_noise_rpy_deg=0.0)
    ref, _ = solve_pose_graph(g, cfg)
    n = mesh.size
    out = {"ref_t": ref.t.numpy()}
    # uninterrupted on every rank, in chunks with every rank kept, and
    # uninterrupted on the ranks that survive the shrink below
    whole, info = seq_pose_graph_solve(mesh, g, cfg)
    chunked, info_c, _ = elastic_seq_pose_graph_solve(g, cfg, chunk=2, mesh=mesh, probe=lambda c, r: r)
    out.update(whole_t=whole.t.numpy(), whole_lam=float(info.lam), chunked_t=chunked.t.numpy(),
               chunked_lam=float(info_c.lam))
    half = list(range(max(1, n // 2)))
    if mesh.rank in half:
        out["survivors_t"] = seq_pose_graph_solve(group_mesh(mesh, half), g, cfg)[0].t.numpy()
    torch.distributed.barrier()

    def shrink(chunk_idx, ranks):  # half the ranks gone from chunk 1 on
        return ranks if chunk_idx == 0 else ranks[: max(1, len(ranks) // 2)]

    def regrow(chunk_idx, ranks):  # half the ranks gone during chunk 1 only
        return ranks[: len(ranks) // 2] if chunk_idx == 1 else ranks

    for name, probe, chunk in (("shrink", shrink, 3), ("regrow", regrow, 2)):
        poses, info, events = elastic_seq_pose_graph_solve(g, cfg, chunk=chunk, mesh=mesh, probe=probe)
        out[f"{name}_t"] = poses.t.numpy()
        out[f"{name}_events"] = np.asarray(events, np.int64).reshape(-1, 3)

    path = str(inp["el_path"]) + f".{n}"

    def crash(chunk_idx, ranks):
        if chunk_idx >= 1:
            raise RuntimeError("simulated process loss")
        return ranks

    try:
        elastic_seq_pose_graph_solve(g, cfg, chunk=2, mesh=mesh, probe=crash, path=path)
        out["crashed"] = np.asarray(False)
    except RuntimeError as e:
        out["crashed"] = np.asarray(str(e) == "simulated process loss")
    torch.distributed.barrier()  # rank 0 wrote the snapshot before its own probe raised
    out["snapshot_left"] = np.asarray(os.path.exists(path))
    torch.distributed.barrier()
    poses, info, events = elastic_seq_pose_graph_solve(g, cfg, chunk=10, mesh=mesh, probe=None, path=path)
    torch.distributed.barrier()
    out["resumed_t"] = poses.t.numpy()
    out["snapshot_removed"] = np.asarray(not os.path.exists(path))
    return out


@job
def mesh_errors(mesh, inp):
    """A mesh larger than the world raises; so does ``mesh_devices`` of it."""
    from diasss_tpu_torch.config import PipelineConfig
    from diasss_tpu_torch.online import OnlineSlam
    from diasss_tpu_torch.parallel.shard import make_mesh

    msgs = []
    for fn in (lambda: make_mesh(mesh.size * 2, device="cpu"),
               lambda: OnlineSlam(PipelineConfig(mesh_devices=mesh.size * 2), device="cpu")):
        try:
            fn()
            msgs.append("no error")
        except RuntimeError as e:
            msgs.append(str(e))
    return {"msgs": np.asarray(msgs)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("torch_parallel_worker")
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--store", required=True)
    parser.add_argument("--inputs", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--jobs", required=True)
    parser.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    from diasss_tpu_torch.parallel.distributed import initialize
    from diasss_tpu_torch.parallel.shard import make_mesh

    if args.device.startswith("cuda"):
        torch.cuda.set_device(torch.device(args.device))
        torch.backends.cuda.matmul.allow_tf32 = False
    initialize(f"file://{args.store}", args.world, args.rank, backend=args.backend, timeout_s=120)
    mesh = make_mesh(args.world, device=args.device)
    inp = dict(np.load(args.inputs, allow_pickle=False))
    results = {}
    for name in args.jobs.split(","):
        for k, v in JOBS[name](mesh, inp).items():
            results[f"{name}/{k}"] = np.asarray(v)
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **results)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
