"""CN-DPM: a Dirichlet-process mixture of VAE + classifier experts
(counterpart of ocl_tpu/models/ndpm.py; reference models/ndpm/*).

As in ocl_tpu, `max_experts` (K) expert slots are pre-allocated with stacked
[K, ...] weights at the padded widths: the first expert is nf_base wide, each
later one nf_ext, and every slot's input takes the widest lateral concat. A
slot's weights are drawn at its true fan-in. An independent dummy expert
(slot-0 widths) scores the short-term memory's column.

What differs from ocl_tpu, with the same numbers:
  * Only born slots are computed (`n`, a Python int), and each slot only at
    its true widths: its weights are sliced to its own output channels and
    to the input channels its precursors wrote. ocl_tpu computes every slot
    at the padded width over zeroed buffers and masks the outputs; the
    padded entries then multiply zeros, so their gradients are zero in both.
  * The lateral features (detached, so no gradient reaches a precursor) are
    concatenated out of place instead of written into zeroed buffers.
  * Layouts: convs OIHW [K, O, I, kh, kw]; the decoder's transposed convs
    [K, I, O, kh, kw] with the kernel flipped along H and W (torch's
    conv_transpose2d flips, lax.conv_transpose does not); dense layers
    [K, in, out] as in JAX, but `enc3_w`'s rows and `dec3_w`'s columns (and
    `dec3_b`) in (C, h, w) order, so that NCHW features flatten straight
    into them and the channels a slot reads are a prefix of the rows.
    `interop.ndpm_from_jax` / `ndpm_to_jax` convert.
  * Stride-2 "SAME" convolutions pad as XLA does, (0, 1) on an even input,
    through an explicit `F.pad`.
  * Every random draw is an argument: the VAE noise, one [B, S, z] tensor a
    column.

The weights are plain tensors (no autograd); a training step takes its
gradients with respect to views of the slots it updates (`leaf_views`).
Images are NHWC at the public functions, as everywhere in the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ocl_tpu_torch.config import input_size_match, n_classes_match
from ocl_tpu_torch.models import ndpm_vars as V

LOG2PI = math.log(2.0 * math.pi)
# classifier levels 1-4: (input concat multiple, output multiple, stride)
CLS_SPECS = ((1, 1, 1), (1, 2, 2), (2, 4, 2), (4, 8, 2))


# ----------------------------------------------------------------- widths

def vae_w(s):
    return V.VAE_NF_BASE if s == 0 else V.VAE_NF_EXT


def vae_off(s):
    return 0 if s == 0 else V.VAE_NF_BASE + (s - 1) * V.VAE_NF_EXT


def vae_cat(s):
    return V.VAE_NF_BASE + s * V.VAE_NF_EXT


def cls_w(s):
    return V.CLS_NF_BASE if s == 0 else V.CLS_NF_EXT


def cls_off(s):
    return 0 if s == 0 else V.CLS_NF_BASE + (s - 1) * V.CLS_NF_EXT


def cls_cat(s):
    return V.CLS_NF_BASE + s * V.CLS_NF_EXT


# ------------------------------------------------------------------- init

def vae_leaf_specs(K, H, W, C):
    """name -> (port shape of one slot, fan_in(s)) of the VAE leaves."""
    Cv, nfb, z = vae_cat(K - 1), V.VAE_NF_BASE, V.VAE_Z_DIM
    cells = (H // 4) * (W // 4)
    specs = {
        "enc1": ((nfb, C, 3, 3), (nfb,), lambda s: C * 9),
        "enc2": ((2 * nfb, Cv, 3, 3), (2 * nfb,), lambda s: vae_cat(s) * 9),
        "enc3": ((cells * 2 * Cv, 4 * nfb), (4 * nfb,), lambda s: cells * 2 * vae_cat(s)),
        "zmu": ((4 * Cv, z), (z,), lambda s: 4 * vae_cat(s)),
        "zlv": ((4 * Cv, z), (z,), lambda s: 4 * vae_cat(s)),
        "decz": ((z, 4 * nfb), (4 * nfb,), lambda s: z),
        "dec3": ((4 * nfb, cells * 2 * nfb), (cells * 2 * nfb,), lambda s: 4 * nfb),
        "dec2": ((2 * nfb, nfb, 4, 4), (nfb,), lambda s: 2 * nfb * 16),
        "dec1": ((nfb, C, 4, 4), (C,), lambda s: nfb * 16),
    }
    out = {}
    for name, (w, b, fan) in specs.items():
        out[name + "_w"] = (w, fan)
        out[name + "_b"] = (b, fan)
    return out


def cls_leaf_specs(K, C, n_cls):
    """name -> (port shape of one slot, fan_in(s)) of the classifier leaves
    (its convs have no bias)."""
    Cc, nb = cls_cat(K - 1), V.CLS_NF_BASE
    out = {"l0_w": ((nb, C, 3, 3), lambda s: C * 9)}
    for i, (mi, mo, _) in enumerate(CLS_SPECS, start=1):
        out[f"l{i}_c1_w"] = ((mo * nb, mi * Cc, 3, 3), lambda s, mi=mi: mi * cls_cat(s) * 9)
        out[f"l{i}_c2_w"] = ((mo * nb, mo * nb, 3, 3), lambda s, mo=mo: mo * cls_w(s) * 9)
        out[f"l{i}_ds_w"] = ((mo * nb, mi * Cc, 1, 1), lambda s, mi=mi: mi * cls_cat(s))
    out["pred_w"] = ((8 * Cc, n_cls), lambda s: 8 * cls_cat(s))
    out["pred_b"] = ((n_cls,), lambda s: 8 * cls_cat(s))
    return out


def _uniform(generator, shape, fan_in):
    """torch's default Linear / Conv init bound, 1 / sqrt(fan_in)."""
    b = 1.0 / math.sqrt(max(fan_in, 1))
    return torch.rand(shape, generator=generator) * (2 * b) - b


def _init_part(specs, slots, generator):
    """Stacked [len(slots), ...] leaves, each slot at its true fan-in."""
    return {name: torch.stack([_uniform(generator, shape, fan(s)) for s in slots])
            for name, (shape, fan) in specs.items()}


class NDPM(nn.Module):
    """The mixture's weights: `vae` and `cls`, stacked [K, ...] leaves, and
    the dummy expert's `dummy_vae` and `dummy_cls` (one slot, frozen). All
    are tensors without autograd; see `leaf_views` for gradients."""

    def __init__(self, params, generator: torch.Generator):
        super().__init__()
        self.K = int(params.max_experts)
        H, W, C = input_size_match[params.data]
        self.hw = (H, W)
        vspecs = vae_leaf_specs(self.K, H, W, C)
        cspecs = cls_leaf_specs(self.K, C, n_classes_match[params.data])

        def pdict(tree):
            return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                     for k, v in tree.items()})

        dummy_v = {k: v[0] for k, v in _init_part(vspecs, [0], generator).items()}
        dummy_c = {k: v[0] for k, v in _init_part(cspecs, [0], generator).items()}
        self.dummy_vae, self.dummy_cls = pdict(dummy_v), pdict(dummy_c)
        self.vae = pdict(_init_part(vspecs, range(self.K), generator))
        self.cls = pdict(_init_part(cspecs, range(self.K), generator))

    def part(self, name):
        """The stacked leaves of `vae` or `cls`, or a dummy's, as a dict."""
        return dict(getattr(self, name).items())


def leaf_views(stacked: dict, lo: int, hi: int, grad: bool = False) -> dict:
    """Views [lo:hi] of stacked leaves; with `grad`, each a fresh autograd
    leaf (sharing storage) to take gradients with respect to."""
    out = {k: v[lo:hi].detach() for k, v in stacked.items()}
    if grad:
        for v in out.values():
            v.requires_grad_()
    return out


def slot_dicts(views: dict) -> list:
    """[n, ...] views -> a list of n per-slot dicts (unbind: one stack in
    the backward pass)."""
    cols = {k: v.unbind(0) for k, v in views.items()}
    n = next(iter(views.values())).shape[0]
    return [{k: cols[k][s] for k in views} for s in range(n)]


def slots_of(model: NDPM, part: str, n: int) -> list:
    return slot_dicts(leaf_views(model.part(part), 0, n))


# ---------------------------------------------------------------- helpers

def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _same_pad(n, k, s):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, b=None, stride=1):
    """lax.conv_general_dilated with "SAME" padding: XLA puts the odd pad
    at the bottom-right."""
    kh, kw = w.shape[2:]
    ph, pw = _same_pad(x.shape[2], kh, stride), _same_pad(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, b, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, b, stride=stride)


def _deconv(x, w, b):
    """lax.conv_transpose (k 4, stride 2, "SAME") with the kernel stored
    flipped in torch's (I, O, kh, kw) layout."""
    return F.conv_transpose2d(x, w, b, stride=2, padding=1)


def _instance_norm(x, eps=1e-5):
    return F.instance_norm(x, eps=eps)


def _lateral(buf, h):
    """The precursors' features (already detached), then this slot's."""
    return h if buf is None else torch.cat([buf, h], 1)


# ----------------------------------------------------------------- VAE

def vae_encode_all(slots, x):
    """z_mu, z_lv lists, one entry a slot of `slots` (per-slot weight
    dicts, slot 0 first); x NCHW. Each slot reads its precursors' features,
    detached."""
    z_mus, z_lvs = [], []
    bufs = (None, None, None)
    for s, p in enumerate(slots):
        wv, cv = vae_w(s), vae_cat(s)
        h1 = F.relu(F.max_pool2d(_conv(x, p["enc1_w"][:wv], p["enc1_b"][:wv]), 2))
        in1 = _lateral(bufs[0], h1)
        h2 = F.relu(F.max_pool2d(_conv(in1, p["enc2_w"][: 2 * wv, :cv],
                                       p["enc2_b"][: 2 * wv]), 2))
        in2 = _lateral(bufs[1], h2)
        flat = in2.flatten(1)
        h3 = F.relu(torch.addmm(p["enc3_b"][: 4 * wv], flat,
                                p["enc3_w"][: flat.shape[1], : 4 * wv]))
        in3 = _lateral(bufs[2], h3)
        z_mus.append(torch.addmm(p["zmu_b"], in3, p["zmu_w"][: 4 * cv]))
        z_lvs.append(torch.addmm(p["zlv_b"], in3, p["zlv_w"][: 4 * cv]))
        bufs = (in1.detach(), in2.detach(), in3.detach())
    return z_mus, z_lvs


def _vae_decode(p, z, out_hw):
    h4, w4 = out_hw[0] // 4, out_hw[1] // 4
    h = F.relu(torch.addmm(p["decz_b"], z, p["decz_w"]))
    h = F.relu(torch.addmm(p["dec3_b"], h, p["dec3_w"]))
    h = h.view(h.shape[0], 2 * V.VAE_NF_BASE, h4, w4)
    h = F.relu(_deconv(h, p["dec2_w"], p["dec2_b"]))
    return torch.sigmoid(_deconv(h, p["dec1_w"], p["dec1_b"]))


def _gaussian_recon_nll(x, x_mean, min_noise=0.001):
    """gaussian_nll with log_var=0 (reference models/ndpm/loss.py:7-11)."""
    return ((x - x_mean) ** 2 + min_noise) / 2.0 + 0.5 * LOG2PI


def _vae_nll_from_z(p, z_mu, z_lv, x, noise):
    """[B] NLL of x (NCHW) under one VAE, from its posterior and `noise`
    [B, S, z] (S z samples)."""
    B, S = noise.shape[:2]
    std = torch.exp(0.5 * z_lv)
    z = (z_mu[:, None, :] + noise * std[:, None, :]).reshape(B * S, -1)
    x_mean = _vae_decode(p, z, x.shape[2:]).view(B, S, *x.shape[1:])
    recon = _gaussian_recon_nll(x[:, None], x_mean)
    recon = recon.reshape(B, S, -1).sum(2).mean(1)
    kl = 0.5 * torch.sum(torch.exp(z_lv) + z_mu ** 2 - 1.0 - z_lv, dim=1)
    return recon + kl


def _dummy_encode(p, x):
    z_mus, z_lvs = vae_encode_all([p], x)
    return z_mus[0], z_lvs[0]


def vae_nlls(dummy, slots, x, noise):
    """[B, 1 + n] VAE NLLs of x (NCHW): the dummy's column, then each slot's
    (`noise[0]` is the dummy's draw, `noise[1 + s]` slot s's)."""
    z_mus, z_lvs = vae_encode_all(slots, x)
    zd_mu, zd_lv = _dummy_encode(dummy, x)
    out = [_vae_nll_from_z(dummy, zd_mu, zd_lv, x, noise[0])]
    for s, p in enumerate(slots):
        out.append(_vae_nll_from_z(p, z_mus[s], z_lvs[s], x, noise[1 + s]))
    return torch.stack(out, dim=1)


def vae_collect_nll(model, x, noise, n):
    """[B, 1 + n]: the dummy's then each born slot's VAE NLL of x (NHWC);
    `noise` holds 1 + n draws of [B, S, z]."""
    return vae_nlls(model.part("dummy_vae"), slots_of(model, "vae", n), _nchw(x), noise)


# ------------------------------------------------------------ classifier

def _cls_block(p, i, x, width_out, stride, has_ds):
    """Level i of a slot's classifier on x, whose channels are all real."""
    cin = x.shape[1]
    h = _conv(x, p[f"l{i}_c1_w"][:width_out, :cin], stride=stride)
    h = F.relu(_instance_norm(h))
    h = _instance_norm(_conv(h, p[f"l{i}_c2_w"][:width_out, :width_out]))
    if has_ds:
        idn = _instance_norm(_conv(x, p[f"l{i}_ds_w"][:width_out, :cin], stride=stride))
    else:
        # identity shortcut only when in == out (slot 0, level 1)
        idn = x
    return F.relu(h + idn)


def _cls_forward_slot(p, s, x, bufs):
    """One slot's classifier on x (NCHW) over its precursors' features
    `bufs` (None for slot 0); returns (log_softmax [B, C], the five levels'
    features with this slot's appended)."""
    wc, cc = cls_w(s), cls_cat(s)
    bufs = bufs or (None,) * 5
    h1 = F.relu(_instance_norm(_conv(x, p["l0_w"][:wc])))
    cur = _lateral(bufs[0], h1)
    feats = [cur]
    for i, (mi, mo, stride) in enumerate(CLS_SPECS, start=1):
        width_out = mo * wc
        has_ds = (stride != 1) or (mi * cc != width_out)
        h = _cls_block(p, i, cur, width_out, stride, has_ds)
        if i < 4:
            cur = _lateral(bufs[i], h)
            feats.append(cur)
        else:
            feats.append(_lateral(bufs[4], h.mean(dim=(2, 3))))
    logits = torch.addmm(p["pred_b"], feats[-1], p["pred_w"][: 8 * cc])
    return F.log_softmax(logits, dim=1), feats


def cls_forward(dummy, slots, x):
    """[B, M, C] log-softmax predictions of x (NCHW): the dummy's (when
    given), then each slot's."""
    preds = [] if dummy is None else [_cls_forward_slot(dummy, 0, x, None)[0]]
    bufs = None
    for s, p in enumerate(slots):
        pred, feats = _cls_forward_slot(p, s, x, bufs)
        preds.append(pred)
        bufs = [f.detach() for f in feats]
    return torch.stack(preds, dim=1)


def cls_collect_forward(model, x, n):
    """[B, 1 + n, C] log-softmax predictions of x (NHWC), dummy first."""
    return cls_forward(model.part("dummy_cls"), slots_of(model, "cls", n), _nchw(x))


def chilled_nll(preds, y, chill):
    """[B, M] chilled NLL of labels y (reference classifier.py:22-35): the
    value with chill, the gradient without, in ocl_tpu's form so the value
    is nll_ch to the last bit."""
    idx = y[:, None, None].expand(-1, preds.shape[1], 1)
    nll = -preds.gather(2, idx)[:, :, 0]
    nll_ch = -F.log_softmax(preds / chill, dim=2).gather(2, idx)[:, :, 0]
    return nll - nll.detach() + nll_ch.detach()


def cls_collect_nll(model, x, y, n, chill):
    """[B, 1 + n] chilled classifier NLLs, dummy first."""
    return chilled_nll(cls_collect_forward(model, x, n), y, chill)


# ---------------------------------------------------------------- top level

def collect_nll(model, x, y, noise, n, chill):
    """[B, 1 + n] joint NLL (VAE + chilled classifier) of (x, y), the
    dummy's column then each born slot's."""
    return vae_collect_nll(model, x, noise, n) + cls_collect_nll(model, x, y, n, chill)


def ndpm_predict(model, x, noise, log_counts, n):
    """[B, C] log joint over classes (reference ndpm.py:24-41), over the n
    born slots; `noise` holds one [B, S, z] draw a born slot."""
    xc = _nchw(x)
    slots = slots_of(model, "vae", n)
    z_mus, z_lvs = vae_encode_all(slots, xc)
    log_evid = -torch.stack([_vae_nll_from_z(p, z_mus[s], z_lvs[s], xc, noise[s])
                             for s, p in enumerate(slots)], dim=1)        # [B, n]
    log_prior = log_counts[1: 1 + n]
    log_prior = log_prior - torch.logsumexp(log_prior, dim=0)
    log_joint = (log_prior[None, :, None] + log_evid[:, :, None] +
                 cls_forward(None, slots_of(model, "cls", n), xc))
    return torch.logsumexp(log_joint, dim=1)
