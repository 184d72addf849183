"""Pipeline overlap of host work with device work.

The port's copies of :mod:`diasss_tpu.parallel.prefetch`'s
:func:`prefetch_iter` (which :meth:`diasss_tpu_torch.online.OnlineSlam.run_stream`
uses), :func:`build_keyframes_pipelined` and :func:`load_keyframes_pipelined`
(the CLI's loading stage): a background thread runs each thunk's host work
(file parse, numpy assembly) for the next items while the consumer thread
does the device work of the current one.  Thunks return host arrays; every
CUDA call stays on the consumer thread.  The JAX package's
``host_preprocess`` / ``host_imagery`` options belong to its remote-TPU
transfer machinery and are not ported (ROADMAP, not to port).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional, Sequence

_SENTINEL = object()


def prefetch_iter(thunks: Iterable[Callable[[], object]], depth: int = 2) -> Iterator[object]:
    """Yield ``thunk()`` results with a background producer thread.

    The producer runs at most ``depth`` items ahead of the consumer.  Thunks
    should do host-side work only (IO, numpy); device calls belong on the
    consumer side.  An exception in a thunk is re-raised in the consumer.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    err: List[BaseException] = []
    stop = threading.Event()  # set when the consumer abandons the generator

    def _put(item) -> bool:
        # timeout-put so an abandoned consumer (generator closed with a full
        # queue) cannot block the producer forever holding file handles open
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for t in thunks:
                if stop.is_set() or not _put(t()):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            err.append(e)
        finally:
            _put(_SENTINEL)

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
    finally:
        # reached on normal exhaustion and on early close or throw from the
        # consumer: release the producer promptly
        stop.set()
        th.join()
    if err:
        raise err[0]


def build_keyframes_pipelined(line_thunks: Sequence[Callable[[], tuple]], detector_cfg=None, depth: int = 2,
                              norm_cfg=None, mask_cfg=None, device="cuda"):
    """Keyframes (and, with ``detector_cfg``, their detected features) of
    lines whose host arrays the thunks return, each ``(img_id, image,
    dr_poses, altitudes, ground_ranges, annos)``: a producer thread runs the
    next thunks while this thread builds and detects the current line on
    ``device``.  Returns ``(frames, feats or None)``."""
    from ..config import MaskConfig, NormalizeConfig
    from ..features import detect_features
    from ..frame import build_keyframe

    norm_cfg = norm_cfg if norm_cfg is not None else NormalizeConfig()
    mask_cfg = mask_cfg if mask_cfg is not None else MaskConfig()
    frames = []
    feats = [] if detector_cfg is not None else None
    for args in prefetch_iter(line_thunks, depth=depth):
        f = build_keyframe(*args, norm_cfg=norm_cfg, mask_cfg=mask_cfg, device=device)
        frames.append(f)
        if detector_cfg is not None:
            feats.append(detect_features(f.norm, f.mask, detector_cfg))
    return frames, feats


class PipelinedLoad(NamedTuple):
    frames: list
    feats: Optional[list]  # detected features per frame, with a detector config
    timings: Dict[str, float]  # load_pipelined_wall, load_host_parse (seconds)
    reader: str  # the file reader that ran (io.loader._readers)


def load_keyframes_pipelined(image_folder: str, pose_folder: str, altitude_folder: str, groundrange_folder: str,
                             annotation_folder: str, detector_cfg=None, use_native: bool = True, depth: int = 2,
                             norm_cfg=None, mask_cfg=None, device="cuda") -> PipelinedLoad:
    """Load a survey's folders as :func:`..io.load_input_data` does and build
    its keyframes (and features, with ``detector_cfg``) on ``device``, with
    the parse of line k+1 on a host thread while line k is built and
    detected.  ``timings['load_host_parse']`` sums the parse time, so the
    overlap is the difference to the wall."""
    from ..io.loader import _readers, _sorted_files

    read_mat, read_txt, reader = _readers(use_native)
    folders = (image_folder, pose_folder, altitude_folder, groundrange_folder, annotation_folder)
    files = [_sorted_files(d) for d in folders]
    if len({len(f) for f in files}) != 1:
        raise ValueError("inconsistent file counts across folders: "
                         + ", ".join(f"{len(f)} in {d}" for f, d in zip(files, folders)))
    parse_s = [0.0]

    def thunk(i, img_f, pose_f, alt_f, gr_f, anno_f):
        t0 = time.perf_counter()
        out = (i, read_mat(img_f, "ct_img"), read_mat(pose_f, "auv_pose"), read_txt(alt_f), read_txt(gr_f),
               read_mat(anno_f, "anno_kps"))
        parse_s[0] += time.perf_counter() - t0
        return out

    t_wall = time.perf_counter()
    thunks = [lambda i=i, fs=fs: thunk(i, *fs) for i, fs in enumerate(zip(*files))]
    frames, feats = build_keyframes_pipelined(thunks, detector_cfg, depth, norm_cfg, mask_cfg, device)
    if frames:
        from ..pipeline import _sync

        _sync(frames[0].geo.device)
    return PipelinedLoad(frames, feats, {"load_pipelined_wall": time.perf_counter() - t_wall,
                                         "load_host_parse": parse_s[0]}, reader)
