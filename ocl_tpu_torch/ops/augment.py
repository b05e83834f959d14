"""SCR's augmentation stack as batched tensor ops on the device (counterpart
of ocl_tpu/ops/augment.py; reference agents/scr.py:18-24: kornia
RandomResizedCrop(scale=(0.2, 1)) -> RandomHorizontalFlip ->
ColorJitter(0.4, 0.4, 0.4, 0.1, p=0.8) -> RandomGrayscale(p=0.2)).

Images are NHWC floats in [0, 1]. The random draws are arguments, as in the
buffer strategies: `draw_scr_transform` makes them, already scaled, and the
ops consume them, so tests hand both packages the same values. Crops are a
bilinear gather with a box per sample (no dynamic slice sizes). The jitter's
four sub-ops run in an order drawn on the host and applied from Python;
ocl_tpu draws the order on the device and applies it with `lax.switch`,
which here would cost a device read a call.
"""

from __future__ import annotations

import math

import torch

SCALE = (0.2, 1.0)               # crop area, fraction of the image
RATIO = (3.0 / 4.0, 4.0 / 3.0)   # crop aspect ratio w / h
TRIES = 10                       # rejection-sampling tries of the crop box
FLIP_P, JITTER_P, GRAY_P = 0.5, 0.8, 0.2
BRIGHTNESS = CONTRAST = SATURATION = 0.4
HUE = 0.1
GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def draw_scr_transform(generator: torch.Generator, host, batch: int, size, tries: int = TRIES):
    """The draws of one `scr_transform` call on `batch` images of `size`
    (H, W): one uniform draw on `generator`'s device, scaled, and the jitter
    order from `host` (a `random.Random`). Keys:

      area, log_r [B, tries]: crop area in pixels and log aspect ratio;
      u_y, u_x [B]: uniforms that place the box;
      flip [B]: horizontal flip;
      on [B]: jitter applied; bf, cf, sf [B]: brightness, contrast and
        saturation factors; hf [B]: hue shift;
      gray [B]: grayscale;
      order: the jitter's sub-ops, a permutation of range(4) (brightness,
        contrast, saturation, hue).
    """
    H, W = size
    u = torch.rand((batch, 2 * tries + 9), generator=generator, device=generator.device)
    t = 2 * tries
    order = list(range(4))
    host.shuffle(order)
    jitter = u[:, t + 4: t + 7] * (2 * BRIGHTNESS) + (1 - BRIGHTNESS)
    return {
        "area": (u[:, :tries] * (SCALE[1] - SCALE[0]) + SCALE[0]) * (H * W),
        "log_r": u[:, tries:t] * (math.log(RATIO[1]) - math.log(RATIO[0])) + math.log(RATIO[0]),
        "u_y": u[:, t], "u_x": u[:, t + 1],
        "flip": u[:, t + 2] < FLIP_P,
        "on": u[:, t + 3] < JITTER_P,
        "bf": jitter[:, 0], "cf": jitter[:, 1], "sf": jitter[:, 2],
        "hf": u[:, t + 7] * (2 * HUE) - HUE,
        "gray": u[:, t + 8] < GRAY_P,
        "order": order,
    }


def bilinear_sample(img, ys, xs):
    """Sample img [B, H, W, C] at float coordinates ys [B, h], xs [B, w]
    (one row and column grid per image) -> [B, h, w, C]."""
    B, H, W, _ = img.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ay = (ys - y0)[:, :, None, None]
    ax = (xs - x0)[:, None, :, None]
    y0 = y0.long().clamp(0, H - 1)
    x0 = x0.long().clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    b = torch.arange(B, device=img.device)[:, None, None]

    def g(yi, xi):
        return img[b, yi[:, :, None], xi[:, None, :]]

    top = g(y0, x0) * (1 - ax) + g(y0, x1) * ax
    bot = g(y1, x0) * (1 - ax) + g(y1, x1) * ax
    return top * (1 - ay) + bot * ay


def crop_resize(img, y0, x0, h, w):
    """Crop box (y0, x0, h, w) [B] of each image of img [B, H, W, C] and
    resize it back to H x W bilinearly (half-pixel centres, as
    align_corners=False).

    The sampling coordinates are clamped to the box ([y0, y0+h-1] x
    [x0, x0+w-1]): torch crops first and interpolates the slice with edge
    replication, so a border pixel never blends in pixels from outside the
    box (ocl_tpu/ops/augment.py:38-46)."""
    H, W = img.shape[1], img.shape[2]
    y0, x0, h, w = (v.to(torch.float32)[:, None] for v in (y0, x0, h, w))
    ry = torch.arange(H, dtype=torch.float32, device=img.device)
    rx = torch.arange(W, dtype=torch.float32, device=img.device)
    ys = torch.clamp(y0 + (ry + 0.5) * h / H - 0.5, min=y0, max=y0 + h - 1)
    xs = torch.clamp(x0 + (rx + 0.5) * w / W - 0.5, min=x0, max=x0 + w - 1)
    return bilinear_sample(img, ys, xs)


def random_resized_crop(x, area, log_r, u_y, u_x):
    """Per-sample crop of random area and aspect ratio, resized to the input
    size. torchvision/kornia's law: of `tries` candidate (area, log ratio)
    pairs, the first whose integer box fits the image, else the whole image;
    integer offsets uniform over [0, H - h] x [0, W - w]."""
    B, H, W, _ = x.shape
    r = torch.exp(log_r)
    w_c = torch.round(torch.sqrt(area * r))
    h_c = torch.round(torch.sqrt(area / r))
    valid = (w_c >= 1) & (w_c <= W) & (h_c >= 1) & (h_c <= H)
    first = valid.int().argmax(1)     # the first valid try (argmax's first maximum)
    any_valid = valid.any(1)
    rows = torch.arange(B, device=x.device)
    w = torch.where(any_valid, w_c[rows, first], W)
    h = torch.where(any_valid, h_c[rows, first], H)
    y0 = torch.floor(u_y * (H - h + 1))
    x0 = torch.floor(u_x * (W - w + 1))
    return crop_resize(x, y0, x0, h, w)


def _per_image(v):
    return v[:, None, None, None]


def random_hflip(x, flip):
    return torch.where(_per_image(flip), x.flip(2), x)


def rgb_to_grayscale(x):
    """[..., 3] -> [..., 1], ITU-R 601 luma weights."""
    w0, w1, w2 = GRAY_WEIGHTS
    return x[..., 0:1] * w0 + x[..., 1:2] * w1 + x[..., 2:3] * w2


def random_grayscale(x, gray):
    return torch.where(_per_image(gray), rgb_to_grayscale(x).expand_as(x), x)


def rgb_to_hsv(x):
    """[..., 3] RGB -> [..., 3] HSV, hue in [0, 1)."""
    r, g, b = x.unbind(-1)
    mx = x.amax(-1)
    mn = x.amin(-1)
    d = mx - mn
    safe_d = torch.where(d > 0, d, 1.0)
    # % of a negative hue is a floor-mod, as Python's and jnp's
    h = torch.where(mx == r, torch.remainder((g - b) / safe_d, 6.0),
                    torch.where(mx == g, (b - r) / safe_d + 2.0, (r - g) / safe_d + 4.0))
    h = torch.where(d > 0, h / 6.0, 0.0)
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, 1.0), 0.0)
    return torch.stack([h, s, mx], dim=-1)


def _pick(i, choices):
    """choices[i] elementwise, i in 0..5 (jnp.select over i == 0, ..., 5)."""
    return torch.stack(choices, dim=-1).gather(-1, i[..., None])[..., 0]


def hsv_to_rgb(hsv):
    h, s, v = hsv.unbind(-1)
    h6 = torch.remainder(h, 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.long(), 6)
    return torch.stack([_pick(i, (v, q, p, p, t, v)), _pick(i, (t, v, v, q, p, p)),
                        _pick(i, (p, p, t, v, v, q))], dim=-1)


def color_jitter(x, on, bf, cf, sf, hf, order, hue_law="turns"):
    """kornia ColorJitter with per-sample factors, its four sub-ops applied
    in `order` (see `draw_scr_transform`) to the images where `on`.

    hue_law is how the hue draw hf ~ U(-0.1, 0.1) applies
    (ocl_tpu/ops/augment.py:130-146): "turns" shifts the normalised HSV hue
    by hf (torchvision; the default), "radians" by hf / 2pi (kornia 0.4),
    "rollblend" blends |hf| of the channel-rolled image."""
    bf, cf, sf = _per_image(bf), _per_image(cf), _per_image(sf)

    def brightness(img):
        return torch.clamp(img * bf, 0.0, 1.0)

    def contrast(img):
        mean_gray = rgb_to_grayscale(img).mean(dim=(1, 2, 3), keepdim=True)
        return torch.clamp(img * cf + mean_gray * (1 - cf), 0.0, 1.0)

    def saturation(img):
        return torch.clamp(img * sf + rgb_to_grayscale(img) * (1 - sf), 0.0, 1.0)

    def hue(img):
        if hue_law == "rollblend":
            f = _per_image(hf.abs())
            return torch.clamp((1.0 - f) * img + f * torch.roll(img, 1, dims=-1), 0.0, 1.0)
        shift = hf / (2.0 * math.pi) if hue_law == "radians" else hf
        h, s, v = rgb_to_hsv(img).unbind(-1)
        h = torch.remainder(h + shift[:, None, None], 1.0)
        return torch.clamp(hsv_to_rgb(torch.stack([h, s, v], dim=-1)), 0.0, 1.0)

    ops = (brightness, contrast, saturation, hue)
    out = x
    for k in order:
        out = ops[k](out)
    return torch.where(_per_image(on), out, x)


def scr_transform(x, draws, hue_law="turns"):
    """The SCR augmentation stack on x [B, H, W, C] with `draws` from
    `draw_scr_transform`."""
    x = random_resized_crop(x, draws["area"], draws["log_r"], draws["u_y"], draws["u_x"])
    x = random_hflip(x, draws["flip"])
    x = color_jitter(x, draws["on"], draws["bf"], draws["cf"], draws["sf"], draws["hf"],
                     draws["order"], hue_law)
    return random_grayscale(x, draws["gray"])
