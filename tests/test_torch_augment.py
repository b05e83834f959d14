"""The port's SCR augmentation (ocl_tpu_torch/ops/augment.py) against
ocl_tpu.ops.augment, op by op, from the same draws: the port's draw dict is
rebuilt from the values ocl_tpu draws from its key (its split layout:
scr_transform 4 ways, the crop 3 ways with log_r from fold_in(r_box, 1), the
jitter 6 ways). atol 1e-5: the ops are elementwise fp32 arithmetic and small
sums, and exp (crop ratio) may differ by an ulp between XLA and torch.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ocl_tpu.ops import augment as j_aug
from ocl_tpu_torch.ops import augment

ATOL = dict(rtol=0, atol=1e-5)
B, H, W = 24, 32, 32
HUE_LAWS = ["turns", "radians", "rollblend"]


def images(seed=0, n=B):
    """Random images, one of them flat grey, one black and one whose red and
    green channels tie: hue and saturation take their d == 0, max == 0 and
    max == r == g branches there."""
    g = np.random.RandomState(seed)
    x = g.rand(n, H, W, 3).astype(np.float32)
    x[1] = 0.4
    x[2] = 0.0
    x[3, :, :, 1] = x[3, :, :, 0]
    return x


def _t(a):
    return torch.tensor(np.asarray(a))


def crop_draws(r1, n=B, tries=10):
    r_box, r_y, r_x = jax.random.split(r1, 3)
    area = jax.random.uniform(r_box, (n, tries), minval=0.2, maxval=1.0) * H * W
    log_r = jax.random.uniform(jax.random.fold_in(r_box, 1), (n, tries),
                               minval=jnp.log(3.0 / 4.0), maxval=jnp.log(4.0 / 3.0))
    return {"area": _t(area), "log_r": _t(log_r), "u_y": _t(jax.random.uniform(r_y, (n,))),
            "u_x": _t(jax.random.uniform(r_x, (n,)))}


def jitter_draws(r3, n=B):
    r_on, r_b, r_c, r_s, r_h, r_ord = jax.random.split(r3, 6)

    def factor(r):
        return _t(jax.random.uniform(r, (n, 1, 1, 1), minval=0.6, maxval=1.4)).reshape(n)

    return {"on": _t(jax.random.uniform(r_on, (n,)) < 0.8), "bf": factor(r_b),
            "cf": factor(r_c), "sf": factor(r_s),
            "hf": _t(jax.random.uniform(r_h, (n, 1, 1), minval=-0.1, maxval=0.1)).reshape(n),
            "order": [int(i) for i in jax.random.permutation(r_ord, 4)]}


def port_draws(key, n=B):
    """ocl_tpu's draws of scr_transform(key, x) as the port's draw dict."""
    r1, r2, r3, r4 = jax.random.split(key, 4)
    return {**crop_draws(r1, n), "flip": _t(jax.random.uniform(r2, (n,)) < 0.5),
            **jitter_draws(r3, n), "gray": _t(jax.random.uniform(r4, (n,)) < 0.2)}


def test_draws_shapes_ranges_and_order():
    g = torch.Generator().manual_seed(0)
    d = augment.draw_scr_transform(g, random.Random(0), 500, (H, W))
    assert d["area"].shape == d["log_r"].shape == (500, 10)
    assert 0.2 * H * W <= d["area"].min() and d["area"].max() <= H * W
    assert np.log(0.75) <= d["log_r"].min() and d["log_r"].max() <= np.log(4 / 3)
    for k in ("bf", "cf", "sf"):
        assert 0.6 <= d[k].min() and d[k].max() <= 1.4
    assert -0.1 <= d["hf"].min() and d["hf"].max() <= 0.1
    for k, p in (("flip", 0.5), ("on", 0.8), ("gray", 0.2)):
        assert d[k].dtype == torch.bool and abs(d[k].float().mean().item() - p) < 0.08
    assert sorted(d["order"]) == [0, 1, 2, 3]
    again = augment.draw_scr_transform(torch.Generator().manual_seed(0), random.Random(0), 500,
                                       (H, W))
    assert again["order"] == d["order"] and torch.equal(again["area"], d["area"])


def test_random_resized_crop_matches_ocl_tpu():
    x = images(1)
    key = jax.random.PRNGKey(11)
    want = j_aug.random_resized_crop(key, jnp.asarray(x))
    d = crop_draws(key)
    got = augment.random_resized_crop(torch.from_numpy(x), d["area"], d["log_r"], d["u_y"],
                                      d["u_x"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


def test_crop_falls_back_to_the_whole_image():
    """No try fits: the whole image, unresized."""
    x = images(2, 4)
    area = torch.full((4, 10), 2.0 * H * W)   # every box larger than the image
    got = augment.random_resized_crop(torch.from_numpy(x), area, torch.zeros(4, 10),
                                      torch.rand(4), torch.rand(4))
    np.testing.assert_allclose(got.numpy(), x, rtol=0, atol=1e-6)


def test_crop_resize_matches_ocl_tpu_and_interpolate_of_the_crop():
    """The clamp of the sampling coordinates to the box
    (ocl_tpu/ops/augment.py:45-46): the port's batched crop equals ocl_tpu's
    and torch's crop-then-interpolate, border ring included (the boxes of
    tests/test_augment.py::test_crop_resize_matches_torch_interpolate)."""
    g = np.random.RandomState(3)
    x = g.rand(32, 32, 3).astype(np.float32)
    boxes = [(0, 0, 32, 32), (5, 9, 13, 17), (0, 3, 7, 29), (25, 25, 7, 7), (2, 2, 28, 3),
             (31, 0, 1, 32)]
    y0, x0, h, w = (torch.tensor([b[i] for b in boxes], dtype=torch.float32) for i in range(4))
    got = augment.crop_resize(torch.from_numpy(x)[None].expand(len(boxes), -1, -1, -1),
                              y0, x0, h, w).numpy()
    for i, (by, bx, bh, bw) in enumerate(boxes):
        crop = torch.from_numpy(x[by:by + bh, bx:bx + bw]).permute(2, 0, 1)[None]
        want = F.interpolate(crop, size=(32, 32), mode="bilinear",
                             align_corners=False)[0].permute(1, 2, 0).numpy()
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-6, err_msg=str(boxes[i]))
        ref = np.asarray(j_aug.crop_resize(jnp.asarray(x), by, bx, bh, bw))
        np.testing.assert_allclose(got[i], ref, **ATOL)


def test_bilinear_sample_matches_ocl_tpu():
    """Coordinates outside the image clamp to its edge in both."""
    x = images(4, 4)
    g = np.random.RandomState(5)
    ys = g.uniform(-2, H + 1, (4, 20)).astype(np.float32)
    xs = g.uniform(-2, W + 1, (4, 24)).astype(np.float32)
    got = augment.bilinear_sample(torch.from_numpy(x), torch.from_numpy(ys), torch.from_numpy(xs))
    want = jax.vmap(j_aug.bilinear_sample)(jnp.asarray(x), jnp.asarray(ys), jnp.asarray(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


def test_random_hflip_and_grayscale_match_ocl_tpu():
    x = images(6)
    key = jax.random.PRNGKey(12)
    flip = _t(jax.random.uniform(key, (B,)) < 0.5)
    assert 0 < flip.sum() < B
    np.testing.assert_array_equal(augment.random_hflip(torch.from_numpy(x), flip).numpy(),
                                  np.asarray(j_aug.random_hflip(key, jnp.asarray(x))))
    gray = _t(jax.random.uniform(key, (B,)) < 0.2)
    assert 0 < gray.sum() < B
    np.testing.assert_allclose(augment.random_grayscale(torch.from_numpy(x), gray).numpy(),
                               np.asarray(j_aug.random_grayscale(key, jnp.asarray(x))), **ATOL)


def test_color_space_ops_match_ocl_tpu():
    x = images(7)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(augment.rgb_to_grayscale(tx).numpy(),
                               np.asarray(j_aug.rgb_to_grayscale(jx)), **ATOL)
    hsv = augment.rgb_to_hsv(tx)
    np.testing.assert_allclose(hsv.numpy(), np.asarray(j_aug.rgb_to_hsv(jx)), **ATOL)
    # hues past the circle and below zero take the floor-mod in both
    g = np.random.RandomState(8)
    shifted = np.asarray(hsv).copy()
    shifted[..., 0] += g.uniform(-1.5, 1.5, shifted.shape[:-1]).astype(np.float32)
    np.testing.assert_allclose(augment.hsv_to_rgb(torch.from_numpy(shifted)).numpy(),
                               np.asarray(j_aug.hsv_to_rgb(jnp.asarray(shifted))), **ATOL)


@pytest.mark.parametrize("hue_law", HUE_LAWS)
def test_color_jitter_matches_ocl_tpu(hue_law):
    x = images(9)
    key = jax.random.PRNGKey(13)
    d = jitter_draws(key)
    got = augment.color_jitter(torch.from_numpy(x), d["on"], d["bf"], d["cf"], d["sf"], d["hf"],
                               d["order"], hue_law)
    want = j_aug.color_jitter(key, jnp.asarray(x), hue_law=hue_law)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


@pytest.mark.parametrize("seed", [14, 15, 16])
@pytest.mark.parametrize("hue_law", HUE_LAWS)
def test_scr_transform_matches_ocl_tpu(hue_law, seed):
    """The whole stack, over keys whose jitter orders differ."""
    x = images(seed)
    key = jax.random.PRNGKey(seed)
    got = augment.scr_transform(torch.from_numpy(x), port_draws(key), hue_law)
    want = j_aug.scr_transform(key, jnp.asarray(x), hue_law=hue_law)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    assert not np.allclose(got.numpy(), x)
