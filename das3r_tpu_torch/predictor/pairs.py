"""Scene-graph pair construction over frame indices (the port's own copy
of ``das3r_tpu/predictor/pairs.py``; the reference's
``make_pairs``, dynamic_predictor/dust3r/image_pairs.py:8-76, operating on
indices instead of image dicts — the pipeline batches frames once and
passes index arrays around).

Supported graphs: 'complete', 'swin-k', 'swinstride-k' (stride 2),
'swin2stride-k' (stride 3), 'swinskip_start...' (start offset 2),
'logwin-k', 'oneref-r'; suffix '-noncyclic' disables loop closure. Default
DAS3R eval graph: 'swinstride-5-noncyclic' (training.py:102), window
downgraded to 4 for >95-frame sequences (pose_eval.py:106-108).
"""
from __future__ import annotations


def make_pairs(n_imgs: int, scene_graph: str = "complete",
               symmetrize: bool = True, prefilter: str | None = None
               ) -> list[tuple[int, int]]:
    pairs: list[tuple[int, int]] = []
    if scene_graph == "complete":
        for i in range(n_imgs):
            for j in range(i):
                pairs.append((i, j))
    elif scene_graph.startswith("swin"):
        iscyclic = not scene_graph.endswith("noncyclic")
        try:
            winsize = int(scene_graph.split("-")[1])
        except (IndexError, ValueError):
            winsize = 3
        if scene_graph.startswith("swinstride"):
            stride = 2
        elif scene_graph.startswith("swin2stride"):
            stride = 3
        else:
            stride = 1
        start = 2 if scene_graph.startswith("swinskip_start") else 1
        pairsid = set()
        for i in range(n_imgs):
            for j in range(start, stride * winsize + start, stride):
                idx = i + j
                if iscyclic:
                    idx = idx % n_imgs
                if idx >= n_imgs:
                    continue
                pairsid.add((i, idx) if i < idx else (idx, i))
        pairs.extend(sorted(pairsid))
    elif scene_graph.startswith("logwin"):
        iscyclic = not scene_graph.endswith("noncyclic")
        try:
            winsize = int(scene_graph.split("-")[1])
        except (IndexError, ValueError):
            winsize = 3
        offsets = [2 ** k for k in range(winsize)]
        pairsid = set()
        for i in range(n_imgs):
            for j in ([i - o for o in offsets] + [i + o for o in offsets]):
                if iscyclic:
                    j = j % n_imgs
                if j < 0 or j >= n_imgs or j == i:
                    continue
                pairsid.add((i, j) if i < j else (j, i))
        pairs.extend(sorted(pairsid))
    elif scene_graph.startswith("oneref"):
        refid = int(scene_graph.split("-")[1]) if "-" in scene_graph else 0
        pairs.extend((refid, j) for j in range(n_imgs) if j != refid)
    else:
        raise ValueError(f"unknown scene graph {scene_graph!r}")

    if (symmetrize and not scene_graph.startswith("oneref")
            and not scene_graph.startswith("swin-1")) or n_imgs == 2:
        pairs = pairs + [(j, i) for i, j in pairs]

    if isinstance(prefilter, str) and prefilter.startswith(("seq", "cyc")):
        thr = int(prefilter[3:])
        cyclic = prefilter.startswith("cyc")
        kept = []
        for (i, j) in pairs:
            dis = abs(i - j)
            if cyclic:
                dis = min(dis, abs(i + n_imgs - j), abs(i - n_imgs - j))
            if dis <= thr:
                kept.append((i, j))
        pairs = kept
    return pairs


def eval_scene_graph(n_frames: int, base: str = "swinstride-5-noncyclic"
                     ) -> str:
    """The pose-eval graph policy: shrink the window for long sequences
    (pose_eval.py:106-108)."""
    if n_frames > 95 and base.startswith("swinstride-5"):
        return "swinstride-4-noncyclic"
    return base
