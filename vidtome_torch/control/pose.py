"""OpenPose body-pose estimation for ``control: openpose``.

Counterpart of ``vidtome_tpu/control/pose.py`` (the reference delegates
pose to controlnet_aux's ``OpenposeDetector``,
``utils/controlnet_utils.py:28-60`` in lixirui142/VidToMe):

  * :class:`BodyPoseModel`, the CMU two-branch cascade body-pose network
    (VGG-ish backbone + 6 stages x {PAF, heatmap} branches), one attribute
    per layer, so the ``body_pose_model.pth`` checkpoint (layer-named keys:
    conv1_1 ... conv4_4_CPM, conv5_k_CPM_L{1,2}, Mconv1_stageN_L{1,2} ...
    Mconv7_stageN_L{1,2}) loads with ``strict=True``; the module-wrapped
    layout (``model0.conv1_1.weight``) loads by its last two name segments,
    as the JAX converter reads it.  It runs on the device the caller names,
    in fp32 with TF32 off;
  * the published post-processing, copied from the JAX package as it
    stands (numpy, scipy, cv2): multi-scale inference (scale_search x
    boxsize/stride padding), gaussian-smoothed peak NMS, part-affinity-field
    limb scoring over 10-point line integrals, greedy subset assembly;
  * controlnet_aux-compatible rendering: 17 limbs as filled ellipse
    polygons (alpha 0.6) + 18 joint circles on a black canvas.

Enabled by ``VIDTOME_POSE_MODEL`` (a ``.pth`` / ``.safetensors`` file or a
directory holding one); without it, ``control: openpose`` fails at
construction (``control/preprocess.validate_control_available``): pose has
no meaningful classical fallback.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vidtome_torch.control.loading import (cached_model, exact_fp32,
                                            model_path)

# (name, out_channels, kernel) per backbone layer; 'P' = 2x2 maxpool
_BACKBONE = (
    ("conv1_1", 64, 3), ("conv1_2", 64, 3), "P",
    ("conv2_1", 128, 3), ("conv2_2", 128, 3), "P",
    ("conv3_1", 256, 3), ("conv3_2", 256, 3), ("conv3_3", 256, 3),
    ("conv3_4", 256, 3), "P",
    ("conv4_1", 512, 3), ("conv4_2", 512, 3),
    ("conv4_3_CPM", 256, 3), ("conv4_4_CPM", 128, 3),
)
_N_PAF, _N_HEAT = 38, 19
_STRIDE, _BOXSIZE, _PAD_VALUE = 8, 368, 128
_THRE1, _THRE2 = 0.1, 0.05
_SCALE_SEARCH = (0.5,)  # controlnet_aux Body.__call__ default

# limb connections over the 18 keypoints + the PAF channel pairs that
# score them (1-indexed in the original tables)
_LIMB_SEQ = [[2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9],
             [9, 10], [10, 11], [2, 12], [12, 13], [13, 14], [2, 1],
             [1, 15], [15, 17], [1, 16], [16, 18], [3, 17], [6, 18]]
_MAP_IDX = [[31, 32], [39, 40], [33, 34], [35, 36], [41, 42], [43, 44],
            [19, 20], [21, 22], [23, 24], [25, 26], [27, 28], [29, 30],
            [47, 48], [49, 50], [53, 54], [51, 52], [55, 56], [37, 38],
            [45, 46]]
_COLORS = [[255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
           [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
           [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
           [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
           [255, 0, 170], [255, 0, 85]]


def stage_layers(stage: int, branch: int, final: int):
    """(name, out_channels, kernel) of one branch of one stage."""
    if stage == 1:
        return [(f"conv5_{i}_CPM_L{branch}", 128, 3) for i in (1, 2, 3)
                ] + [(f"conv5_4_CPM_L{branch}", 512, 1),
                     (f"conv5_5_CPM_L{branch}", final, 1)]
    return [(f"Mconv{i}_stage{stage}_L{branch}", 128, 7)
            for i in (1, 2, 3, 4, 5)
            ] + [(f"Mconv6_stage{stage}_L{branch}", 128, 1),
                 (f"Mconv7_stage{stage}_L{branch}", final, 1)]


class BodyPoseModel(nn.Module):
    """x: [B, 3, H, W] (preprocessed: /256 - 0.5, BGR) ->
    (paf [B, 38, H/8, W/8], heatmap [B, 19, H/8, W/8])."""

    def __init__(self):
        super().__init__()
        ch = 3
        for spec in _BACKBONE:
            if spec != "P":
                name, out, k = spec
                self.add_module(name, nn.Conv2d(ch, out, k, padding=k // 2))
                ch = out
        feat = ch
        self.stages = []
        for stage in range(1, 7):
            branches = []
            for branch, final in ((1, _N_PAF), (2, _N_HEAT)):
                ch = feat if stage == 1 else feat + _N_PAF + _N_HEAT
                names = []
                for name, out, k in stage_layers(stage, branch, final):
                    self.add_module(name, nn.Conv2d(ch, out, k,
                                                    padding=k // 2))
                    names.append(name)
                    ch = out
                branches.append(names)
            self.stages.append(branches)

    def forward(self, x: torch.Tensor):
        h = x
        for spec in _BACKBONE:
            if spec == "P":
                h = F.max_pool2d(h, 2, 2)
            else:
                h = F.relu(getattr(self, spec[0])(h))
        feat = h
        paf = heat = None
        for stage, branches in enumerate(self.stages):
            inp = feat if stage == 0 else torch.cat([paf, heat, feat], 1)
            outs = []
            for names in branches:
                g = inp
                for i, name in enumerate(names):
                    g = getattr(self, name)(g)
                    if i < len(names) - 1:
                        g = F.relu(g)
                outs.append(g)
            paf, heat = outs
        return paf, heat


def load_pose(state: dict) -> BodyPoseModel:
    """The net of a ``body_pose_model.pth`` state dict, raw layer-named or
    module-wrapped: keys are matched by their last two segments."""
    flat = {}
    for k, v in state.items():
        parts = k.split(".")
        if len(parts) >= 2 and parts[-1] in ("weight", "bias"):
            flat[".".join(parts[-2:])] = v
    model = BodyPoseModel()
    model.load_state_dict(flat, strict=True)
    return model


def pose_forward(model_path: str, device="cuda"):
    """``fwd(x)``: [1, H, W, 3] fp32 numpy (preprocessed BGR) -> (paf
    [1, H/8, W/8, 38], heatmap [1, H/8, W/8, 19]) fp32 numpy, from the net
    on ``device`` (the JAX package's forward takes and gives NHWC)."""
    model = cached_model("pose", model_path, device, load_pose)

    def fwd(x: np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(
            np.asarray(x, np.float32).transpose(0, 3, 1, 2)))
        with torch.inference_mode(), exact_fp32():
            paf, heat = model(t.to(device))
        return (paf.permute(0, 2, 3, 1).cpu().numpy(),
                heat.permute(0, 2, 3, 1).cpu().numpy())

    return fwd


# ---------------------------------------------------------------------
# postprocess (pure numpy — published OpenPose recipe)


def _pad_rd(img: np.ndarray, stride: int, pad_value: int):
    """Pad right/down to a stride multiple (padRightDownCorner)."""
    h, w = img.shape[:2]
    pad_d = (stride - h % stride) % stride
    pad_r = (stride - w % stride) % stride
    out = np.pad(img, ((0, pad_d), (0, pad_r), (0, 0)), mode="constant",
                 constant_values=pad_value)
    return out, (pad_d, pad_r)


def infer_maps(oriImg: np.ndarray, fwd) -> tuple[np.ndarray, np.ndarray]:
    """BGR uint8 [H, W, 3] -> (heatmap_avg [H, W, 19], paf_avg
    [H, W, 38]) averaged over the scale search."""
    import cv2

    H, W = oriImg.shape[:2]
    heat_avg = np.zeros((H, W, _N_HEAT), np.float32)
    paf_avg = np.zeros((H, W, _N_PAF), np.float32)
    scales = [s * _BOXSIZE / H for s in _SCALE_SEARCH]
    for scale in scales:
        img = cv2.resize(oriImg, (0, 0), fx=scale, fy=scale,
                         interpolation=cv2.INTER_CUBIC)
        img, (pad_d, pad_r) = _pad_rd(img, _STRIDE, _PAD_VALUE)
        inp = img.astype(np.float32) / 256.0 - 0.5
        paf, heat = fwd(inp[None])
        paf = np.asarray(paf, np.float32)[0]
        heat = np.asarray(heat, np.float32)[0]

        def up(m):
            m = cv2.resize(m, (0, 0), fx=_STRIDE, fy=_STRIDE,
                           interpolation=cv2.INTER_CUBIC)
            m = m[: m.shape[0] - pad_d or None,
                  : m.shape[1] - pad_r or None]
            return cv2.resize(m, (W, H), interpolation=cv2.INTER_CUBIC)

        heat_avg += up(heat) / len(scales)
        paf_avg += up(paf) / len(scales)
    return heat_avg, paf_avg


def find_peaks(heatmap_avg: np.ndarray):
    """Per-part gaussian-smoothed 4-neighbour NMS.  Returns a list of 18
    arrays [(x, y, score, global_id), ...]."""
    from scipy.ndimage import gaussian_filter

    all_peaks = []
    peak_counter = 0
    for part in range(18):
        map_ori = heatmap_avg[:, :, part]
        one = gaussian_filter(map_ori, sigma=3)
        m_l = np.zeros_like(one)
        m_l[:, 1:] = one[:, :-1]
        m_r = np.zeros_like(one)
        m_r[:, :-1] = one[:, 1:]
        m_u = np.zeros_like(one)
        m_u[1:, :] = one[:-1, :]
        m_d = np.zeros_like(one)
        m_d[:-1, :] = one[1:, :]
        binary = np.logical_and.reduce(
            (one >= m_l, one >= m_r, one >= m_u, one >= m_d,
             one > _THRE1))
        ys, xs = np.nonzero(binary)
        peaks = [(x, y, map_ori[y, x], peak_counter + i)
                 for i, (x, y) in enumerate(zip(xs, ys))]
        peak_counter += len(peaks)
        all_peaks.append(peaks)
    return all_peaks


def score_connections(all_peaks, paf_avg, H):
    """PAF line-integral scoring -> per-limb accepted connections."""
    connection_all, special_k = [], []
    mid_num = 10
    for k in range(len(_MAP_IDX)):
        score_mid = paf_avg[:, :, [x - 19 for x in _MAP_IDX[k]]]
        candA = all_peaks[_LIMB_SEQ[k][0] - 1]
        candB = all_peaks[_LIMB_SEQ[k][1] - 1]
        if not candA or not candB:
            special_k.append(k)
            connection_all.append([])
            continue
        connection_candidate = []
        for i, a in enumerate(candA):
            for j, b in enumerate(candB):
                vec = np.subtract(b[:2], a[:2], dtype=np.float64)
                norm = max(0.001, math.sqrt(vec[0] ** 2 + vec[1] ** 2))
                vec = vec / norm
                xs = np.linspace(a[0], b[0], num=mid_num)
                ys = np.linspace(a[1], b[1], num=mid_num)
                vec_x = np.array([
                    score_mid[int(round(ys[t])), int(round(xs[t])), 0]
                    for t in range(mid_num)])
                vec_y = np.array([
                    score_mid[int(round(ys[t])), int(round(xs[t])), 1]
                    for t in range(mid_num)])
                score_midpts = vec_x * vec[0] + vec_y * vec[1]
                score_with_dist = (score_midpts.mean()
                                   + min(0.5 * H / norm - 1, 0))
                crit1 = np.count_nonzero(
                    score_midpts > _THRE2) > 0.8 * len(score_midpts)
                crit2 = score_with_dist > 0
                if crit1 and crit2:
                    connection_candidate.append(
                        [i, j, score_with_dist,
                         score_with_dist + a[2] + b[2]])
        connection_candidate.sort(key=lambda x: x[2], reverse=True)
        connection = np.zeros((0, 5))
        for i, j, s, _ in connection_candidate:
            if i not in connection[:, 3] and j not in connection[:, 4]:
                connection = np.vstack(
                    [connection, [candA[i][3], candB[j][3], s, i, j]])
                if len(connection) >= min(len(candA), len(candB)):
                    break
        connection_all.append(connection)
    return connection_all, special_k


def assemble_subsets(all_peaks, connection_all, special_k):
    """Greedy person assembly.  Returns (candidate [N, 4], subset
    [P, 20]): subset rows hold candidate ids per part, then total score
    and part count."""
    candidate = np.array(
        [item for sublist in all_peaks for item in sublist], ndmin=2)
    subset = -1 * np.ones((0, 20))
    for k in range(len(_MAP_IDX)):
        if k in special_k or len(connection_all[k]) == 0:
            continue
        partAs = connection_all[k][:, 0]
        partBs = connection_all[k][:, 1]
        indexA, indexB = np.array(_LIMB_SEQ[k]) - 1
        for i in range(len(connection_all[k])):
            found = 0
            subset_idx = [-1, -1]
            for j in range(len(subset)):
                if (subset[j][indexA] == partAs[i]
                        or subset[j][indexB] == partBs[i]):
                    subset_idx[found] = j
                    found += 1
            if found == 1:
                j = subset_idx[0]
                if subset[j][indexB] != partBs[i]:
                    subset[j][indexB] = partBs[i]
                    subset[j][-1] += 1
                    subset[j][-2] += (
                        candidate[partBs[i].astype(int), 2]
                        + connection_all[k][i][2])
            elif found == 2:
                j1, j2 = subset_idx
                membership = ((subset[j1] >= 0).astype(int)
                              + (subset[j2] >= 0).astype(int))[:-2]
                if len(np.nonzero(membership == 2)[0]) == 0:
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += connection_all[k][i][2]
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][indexB] = partBs[i]
                    subset[j1][-1] += 1
                    subset[j1][-2] += (
                        candidate[partBs[i].astype(int), 2]
                        + connection_all[k][i][2])
            elif not found and k < 17:
                row = -1 * np.ones(20)
                row[indexA] = partAs[i]
                row[indexB] = partBs[i]
                row[-1] = 2
                row[-2] = (
                    sum(candidate[connection_all[k][i, :2].astype(int), 2])
                    + connection_all[k][i][2])
                subset = np.vstack([subset, row])
    delete_idx = [i for i in range(len(subset))
                  if subset[i][-1] < 4 or subset[i][-2] / subset[i][-1] < 0.4]
    return candidate, np.delete(subset, delete_idx, axis=0)


def draw_bodypose(canvas: np.ndarray, candidate, subset) -> np.ndarray:
    """controlnet_aux-compatible rendering: 17 limb ellipses at alpha 0.6
    + joint circles.  canvas: BGR uint8, modified copy returned."""
    import cv2

    stickwidth = 4
    canvas = canvas.copy()
    for i in range(17):
        for n in range(len(subset)):
            index = subset[n][np.array(_LIMB_SEQ[i]) - 1]
            if -1 in index:
                continue
            cur_canvas = canvas.copy()
            Y = candidate[index.astype(int), 0]
            X = candidate[index.astype(int), 1]
            mX, mY = np.mean(X), np.mean(Y)
            length = ((X[0] - X[1]) ** 2 + (Y[0] - Y[1]) ** 2) ** 0.5
            angle = math.degrees(math.atan2(X[0] - X[1], Y[0] - Y[1]))
            polygon = cv2.ellipse2Poly(
                (int(mY), int(mX)), (int(length / 2), stickwidth),
                int(angle), 0, 360, 1)
            cv2.fillConvexPoly(cur_canvas, polygon, _COLORS[i])
            canvas = cv2.addWeighted(canvas, 0.4, cur_canvas, 0.6, 0)
    for i in range(18):
        for n in range(len(subset)):
            index = int(subset[n][i])
            if index == -1:
                continue
            x, y = candidate[index][0:2]
            cv2.circle(canvas, (int(x), int(y)), 4, _COLORS[i],
                       thickness=-1)
    return canvas


def detect(bgr: np.ndarray, fwd) -> tuple:
    """(peaks, connections, special_k, candidates, subsets) of the body
    net ``fwd`` on one [H, W, 3] uint8 BGR frame."""
    heat, paf = infer_maps(bgr, fwd)
    all_peaks = find_peaks(heat)
    conns, special = score_connections(all_peaks, paf, bgr.shape[0])
    candidate, subset = assemble_subsets(all_peaks, conns, special)
    return all_peaks, conns, special, candidate, subset


def pose_difference(a: tuple, b: tuple, rtol: float) -> str | None:
    """What differs between two detections (:func:`detect`'s tuples): the
    peaks (positions and ids), connections and subsets (members and counts)
    must be equal, their scores equal to ``rtol``; None where they agree."""
    peaks_a, conns_a, special_a, cand_a, sub_a = a
    peaks_b, conns_b, special_b, cand_b, sub_b = b

    def same(x, y, score: int) -> bool:
        x, y = np.asarray(x, float), np.asarray(y, float)
        if x.shape != y.shape:
            return False
        if not x.size:
            return True
        rest = np.arange(x.shape[1]) != score % x.shape[1]
        return (np.array_equal(x[:, rest], y[:, rest])
                and np.allclose(x[:, score], y[:, score], rtol=rtol, atol=0))

    if list(special_a) != list(special_b):
        return "special_k"
    if [len(p) for p in peaks_a] != [len(p) for p in peaks_b]:
        return "peak counts"
    if not same(cand_a, cand_b, 2):
        return "candidates"
    if len(conns_a) != len(conns_b) or not all(
            same(x, y, 2) for x, y in zip(conns_a, conns_b)):
        return "connections"
    if not same(sub_a, sub_b, -2):
        return "subsets"
    return None


def detect_and_draw(image01: np.ndarray, fwd) -> np.ndarray:
    """[H, W, 3] RGB in [0,1] -> pose rendering [H, W, 3] in [0,1]."""
    bgr = (np.clip(image01, 0, 1) * 255).astype(np.uint8)[:, :, ::-1]
    _, _, _, candidate, subset = detect(bgr, fwd)
    canvas = np.zeros_like(bgr)
    canvas = draw_bodypose(canvas, candidate, subset)
    return canvas[:, :, ::-1].astype(np.float32) / 255.0


def pose_images(images: np.ndarray, model_path: str,
                device="cuda") -> np.ndarray:
    """[T, H, W, 3] RGB in [0,1] -> pose control images, same shape."""
    fwd = pose_forward(model_path, device)
    return np.stack([detect_and_draw(img, fwd)
                     for img in np.asarray(images, np.float32)])


def pose_model_path() -> str | None:
    return model_path("VIDTOME_POSE_MODEL")
