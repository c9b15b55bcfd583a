"""The port's ORB front end (uslam_tpu_torch/frontend) against the JAX
package's, fed the same numpy images.

Exact where the JAX package is exact on the CPU: keypoint positions,
levels, masks and descriptors (int32 bit-views of JAX's uint32 words) on
masked-in slots, match indices, RANSAC inliers given JAX's own hypothesis
indices, and the track ids of the chunked front end. Harris scores and
orientation angles are continuous and carry float noise (XLA fuses and may
contract multiply-adds; the 37x37 moment sums reduce in another order), so
they are held to 1e-5 relative and 1e-3 rad; neither moved a keypoint or a
descriptor bit in these tests. Normalized coordinates within 1e-6, the JAX
package's own tolerance between its per-frame and chunked paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import shift as nd_shift

from tests.test_frontend import textured_image
from uslam_tpu.config import CameraConfig, FrontendConfig
from uslam_tpu.frontend import match as jmatch
from uslam_tpu.frontend import orb as jorb
from uslam_tpu.frontend import tracker as jtracker
from uslam_tpu_torch import config as tconfig
from uslam_tpu_torch.frontend import match as tmatch
from uslam_tpu_torch.frontend import orb as torb
from uslam_tpu_torch.frontend import tracker as ttracker
from uslam_tpu_torch.interop import config_to_port, from_port


def jax_ransac_indices(k: int) -> np.ndarray:
    """The hypothesis indices ``tracker.ransac_translation`` draws."""
    return np.array(jax.random.randint(jax.random.PRNGKey(0), (64,), 0, k))


def _stereo_pair(h, w, disp=8.0, seed=3):
    left = textured_image(h, w, seed=seed)
    return left, nd_shift(left, (0, -disp), order=1, mode="nearest").astype(np.float32)


@pytest.mark.parametrize("h, w, levels", [(192, 256, 1), (240, 384, 3)])
def test_extract_orb_batch_matches_jax(h, w, levels):
    imgs = np.stack([textured_image(h, w, seed=s) for s in (3, 4, 5)])
    cfg = FrontendConfig(pyramid_levels=levels)
    kj = jax.device_get(jorb.extract_orb_batch(jnp.asarray(imgs), cfg))
    kt = from_port(torb.extract_orb_batch(torch.from_numpy(imgs), config_to_port(cfg)), kj)
    np.testing.assert_array_equal(kt.mask, kj.mask)
    m = kj.mask
    assert m.sum(axis=1).min() >= 24
    for f in ("xy", "level", "desc"):
        np.testing.assert_array_equal(getattr(kt, f)[m], getattr(kj, f)[m], err_msg=f)
    np.testing.assert_allclose(kt.score[m], kj.score[m], rtol=1e-5)
    np.testing.assert_allclose(kt.angle[m], kj.angle[m], atol=1e-3)


def test_grid_topk_ties_take_lowest_index():
    """Empty cells are all filler scores: the slots must come out in index
    order, as ``jax.lax.top_k`` returns them."""
    score = np.zeros((1, 24, 32), np.float32)
    valid = np.zeros((1, 24, 32), bool)
    valid[0, 5, 7] = True
    score[0, 5, 7] = 3.0
    ys, xs, vals, mask = torb._grid_topk(
        torch.from_numpy(score), torch.from_numpy(valid), 3, 4, 4
    )
    jys, jxs, jvals, jmask = (np.asarray(a) for a in jorb._grid_topk(
        jnp.asarray(score[0]), jnp.asarray(valid[0]), 3, 4, 4))
    np.testing.assert_array_equal(ys[0].numpy(), jys)
    np.testing.assert_array_equal(xs[0].numpy(), jxs)
    np.testing.assert_array_equal(mask[0].numpy(), jmask)
    assert mask.sum() == 1


def test_stereo_and_temporal_matching_match_jax():
    cfg = FrontendConfig(pyramid_levels=1, max_features_per_cell=6)
    lefts, rights = zip(*(_stereo_pair(192, 256, seed=s) for s in (3, 3, 6)))
    # Frame 1 is frame 0 moved by (1, 3) px: real temporal matches.
    lefts = (lefts[0], nd_shift(lefts[0], (1, 3), order=1, mode="nearest"), lefts[2])
    imgs = np.stack([im for pair in zip(lefts, rights) for im in pair]).astype(np.float32)
    kt = torb.extract_orb_batch(torch.from_numpy(imgs), config_to_port(cfg))
    kj = jax.device_get(jorb.extract_orb_batch(jnp.asarray(imgs), cfg))
    L, R = slice(0, None, 2), slice(1, None, 2)
    sm = tmatch.stereo_match(kt.desc[L], kt.xy[L], kt.mask[L], kt.desc[R], kt.xy[R], kt.mask[R])
    prev = slice(0, -1)
    tm = tmatch.match_descriptors(
        kt.desc[L][1:], kt.mask[L][1:], kt.desc[L][prev], kt.mask[L][prev]
    )
    n_stereo = n_temporal = 0
    for f in range(3):
        l, r = 2 * f, 2 * f + 1
        ref = jmatch.stereo_match(kj.desc[l], kj.xy[l], kj.mask[l], kj.desc[r], kj.xy[r], kj.mask[r])
        for a, b in zip(sm, ref):
            np.testing.assert_array_equal(a[f].numpy(), np.asarray(b))
        n_stereo += int(np.asarray(ref.mask).sum())
        if f < 2:
            ref_t = jmatch.match_descriptors(kj.desc[l + 2], kj.mask[l + 2], kj.desc[l], kj.mask[l])
            for a, b in zip(tm, ref_t):
                np.testing.assert_array_equal(a[f].numpy(), np.asarray(b))
            n_temporal += int(np.asarray(ref_t.mask).sum())
    assert n_stereo >= 20 and n_temporal >= 10


def test_chunk_matches_one_launch_equals_separate_calls_and_jax():
    """The chunk's single (2C, K, 8) Hamming call gives the same Matches as
    separate stereo_match / match_descriptors calls, and as the JAX
    package's match functions on the same numpy descriptors."""
    cfg = tconfig.FrontendConfig(pyramid_levels=1, max_features_per_cell=6)
    pairs = [_stereo_pair(192, 256, seed=s) for s in (3, 3, 6, 7)]
    lefts = [p[0] for p in pairs]
    lefts[1] = nd_shift(lefts[0], (1, 3), order=1, mode="nearest")  # real temporal matches
    imgs = np.stack([im for l, (_, r) in zip(lefts, pairs) for im in (l, r)]).astype(np.float32)
    kp = torb.extract_orb_batch(torch.from_numpy(imgs), cfg)
    kp_l = torb.Keypoints(*(a[2::2] for a in kp))          # the chunk: pairs 1..3
    kp_r = torb.Keypoints(*(a[3::2] for a in kp))
    prev = torb.Keypoints(*(a[0] for a in kp))              # left image of pair 0
    sm, tm = ttracker.chunk_matches(kp_l, kp_r, prev, cfg)

    gates = dict(max_distance=cfg.match_max_distance, ratio=cfg.match_ratio)
    sgates = dict(gates, max_v_diff=cfg.stereo_max_v_diff, min_disparity=cfg.stereo_min_disparity)
    pdesc = torch.cat([prev.desc[None], kp_l.desc[:-1]])
    pmask = torch.cat([prev.mask[None], kp_l.mask[:-1]])
    sm_sep = tmatch.stereo_match(kp_l.desc, kp_l.xy, kp_l.mask, kp_r.desc, kp_r.xy, kp_r.mask,
                                 **sgates)
    tm_sep = tmatch.match_descriptors(kp_l.desc, kp_l.mask, pdesc, pmask, **gates)
    for a, b in zip((*sm, *tm), (*sm_sep, *tm_sep)):
        assert torch.equal(a, b)

    u32 = lambda t: jnp.asarray(t.numpy().view(np.uint32))  # noqa: E731
    for f in range(3):
        ref_s = jmatch.stereo_match(u32(kp_l.desc[f]), jnp.asarray(kp_l.xy[f].numpy()),
                                    jnp.asarray(kp_l.mask[f].numpy()), u32(kp_r.desc[f]),
                                    jnp.asarray(kp_r.xy[f].numpy()),
                                    jnp.asarray(kp_r.mask[f].numpy()), **sgates)
        ref_t = jmatch.match_descriptors(u32(kp_l.desc[f]), jnp.asarray(kp_l.mask[f].numpy()),
                                         u32(pdesc[f]), jnp.asarray(pmask[f].numpy()), **gates)
        for a, b in zip((*sm, *tm), (*ref_s, *ref_t)):
            np.testing.assert_array_equal(a[f].numpy(), np.asarray(b))
    assert int(sm.mask.sum()) >= 20 and int(tm.mask[0].sum()) >= 10


def test_ransac_translation_matches_jax_with_its_indices():
    rng = np.random.default_rng(1)
    K = 48
    flow = (rng.normal(0.0, 0.5, (4, K, 2)) + np.array([3.0, -1.0])).astype(np.float32)
    flow[:, ::5] += rng.uniform(10, 40, (4, len(range(0, K, 5)), 2)).astype(np.float32)
    mask = rng.uniform(size=(4, K)) < 0.8
    mask[3] = False                     # no valid flow: mask passes through
    idx = jax_ransac_indices(K)
    ours = ttracker.ransac_translation(
        torch.from_numpy(flow), torch.from_numpy(mask), torch.from_numpy(idx), 3.0
    ).numpy()
    for f in range(4):
        ref = jtracker.ransac_translation(jnp.asarray(flow[f]), jnp.asarray(mask[f]), 3.0)
        np.testing.assert_array_equal(ours[f], np.asarray(ref))


def test_rotation_warp_matches_jax():
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 400, (3, 20, 2)).astype(np.float32)
    rv = rng.normal(0, 0.05, (3, 3)).astype(np.float32)
    kvec = np.array([300.0, 300.0, 192.0, 120.0], np.float32)
    ours = ttracker.rotation_warp(torch.from_numpy(xy), torch.from_numpy(rv), torch.from_numpy(kvec))
    for f in range(3):
        ref = jtracker.rotation_warp(jnp.asarray(xy[f]), jnp.asarray(rv[f]), jnp.asarray(kvec))
        # f32 pixel coordinates ~400: a few ulps.
        np.testing.assert_allclose(ours[f].numpy(), np.asarray(ref), rtol=0, atol=2e-4)


def test_process_chunk_matches_jax():
    """The chunked front end over 7 frames in chunks of 4 (one padded
    tail chunk, a track crossing the chunk boundary), with gyro rotation."""
    cam = CameraConfig(fx=200.0, fy=200.0, cx=128.0, cy=96.0, baseline=0.1,
                       resolution_x=256, resolution_y=192)
    cfg = FrontendConfig(pyramid_levels=1, max_features_per_cell=6)
    img = textured_image()
    lefts, rights = [], []
    for step in range(7):
        left = nd_shift(img, (step, 3 * step), order=1, mode="nearest")
        lefts.append(left)
        rights.append(nd_shift(left, (0, -8.0), order=1, mode="nearest"))
    lefts, rights = np.stack(lefts).astype(np.float32), np.stack(rights).astype(np.float32)
    rvs = np.zeros((7, 3), np.float32)
    rvs[4:] = [1e-3, -2e-3, 5e-4]
    ts = 0.2 * np.arange(7)

    fe_j = jtracker.StereoFrontend(cam, cfg)
    fe_t = ttracker.StereoFrontend(
        config_to_port(cam), config_to_port(cfg), device="cpu",
        ransac_idx=jax_ransac_indices(cfg.max_features),
    )
    got_j, got_t = [], []
    for c0 in range(0, 7, 4):
        c1 = min(c0 + 4, 7)
        args = (lefts[c0:c1], rights[c0:c1], ts[c0:c1], rvs[c0:c1])
        pad = 4 if c1 - c0 < 4 else None
        got_j.extend(fe_j.process_chunk(*args, pad_to=pad))
        got_t.extend(fe_t.process_chunk(*args, pad_to=pad))
    assert len(got_t) == len(got_j) == 7
    assert len(got_j[0].ids) >= 8
    for a, b in zip(got_j, got_t):
        np.testing.assert_array_equal(b.ids, a.ids)
        for fa, fb in zip((a.u0, a.v0, a.u1, a.v1), (b.u0, b.v0, b.u1, b.v1)):
            np.testing.assert_allclose(fb, fa, rtol=0, atol=1e-6)
    assert len(np.intersect1d(got_t[3].ids, got_t[4].ids)) >= 3


def test_seeded_ransac_indices_are_deterministic():
    cam, cfg = tconfig.CameraConfig(), tconfig.FrontendConfig()
    a = ttracker.StereoFrontend(cam, cfg, device="cpu", seed=5).ransac_idx
    b = ttracker.StereoFrontend(cam, cfg, device="cpu", seed=5).ransac_idx
    assert torch.equal(a, b) and a.shape == (64,)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.max_features
