"""The port's buffer primitives against ocl_tpu.buffer with the same random
draws: both packages get the uniforms / Gumbel noise that ocl_tpu draws from
its key, so slots, labels and class_counts must be equal exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocl_tpu.buffer import reservoir as j_reservoir
from ocl_tpu.buffer import retrieve as j_retrieve
from ocl_tpu.buffer.state import init_buffer as j_init_buffer
from ocl_tpu_torch.buffer import reservoir, retrieve
from ocl_tpu_torch.buffer.state import init_buffer

MEM, N_CLS = 40, 10
TEMPLATES = np.random.RandomState(1234).rand(N_CLS, 32, 32, 3)


def class_images(labels, g):
    """A class template plus noise per label, as the synthetic stream makes
    them: images of one class share features, so nearest-neighbour orders are
    decided by the data and not by rounding."""
    x = 0.5 + 0.8 * (TEMPLATES[labels] - 0.5) + g.normal(0, 0.1, (len(labels), 32, 32, 3))
    return np.clip(x, 0, 1).astype(np.float32)


def make_buffers(mem, fill, n_seen, seed, data="synthetic", labels=None, score=None):
    """(ocl_tpu BufferState, port BufferState) holding the same images and
    labels (random unless given) in the first `fill` slots, and the same GSS
    `score` [mem] (zeros unless given)."""
    g = np.random.RandomState(seed)
    imgs = np.zeros((mem, 32, 32, 3), np.float32)
    if labels is None:
        labels = np.zeros(mem, np.int64)
        labels[:fill] = g.randint(0, N_CLS, fill)
    imgs[:fill] = class_images(labels[:fill], g)
    counts = np.bincount(labels[:fill], minlength=N_CLS)
    score = np.zeros(mem, np.float32) if score is None else np.asarray(score, np.float32)
    jbuf = j_init_buffer(mem, data).replace(
        imgs=jnp.asarray(imgs), labels=jnp.asarray(labels, jnp.int32),
        current_index=jnp.asarray(fill, jnp.int32),
        n_seen_so_far=jnp.asarray(n_seen, jnp.int32),
        score=jnp.asarray(score), class_counts=jnp.asarray(counts, jnp.int32))
    tbuf = init_buffer(mem, data, "cpu")
    tbuf.imgs.copy_(torch.from_numpy(imgs))
    tbuf.labels.copy_(torch.from_numpy(labels))
    tbuf.class_counts.copy_(torch.from_numpy(counts))
    tbuf.score.copy_(torch.from_numpy(score))
    tbuf.current_index, tbuf.n_seen_so_far = fill, n_seen
    return jbuf, tbuf


def assert_buffers_equal(jbuf, tbuf):
    np.testing.assert_array_equal(tbuf.imgs.numpy(), np.asarray(jbuf.imgs))
    np.testing.assert_array_equal(tbuf.labels.numpy(), np.asarray(jbuf.labels))
    np.testing.assert_array_equal(tbuf.class_counts.numpy(), np.asarray(jbuf.class_counts))
    assert tbuf.current_index == int(jbuf.current_index)
    assert tbuf.n_seen_so_far == int(jbuf.n_seen_so_far)
    np.testing.assert_allclose(tbuf.score.numpy(), np.asarray(jbuf.score), rtol=1e-3, atol=1e-4)
    valid = tbuf.labels[: tbuf.current_index].numpy()
    np.testing.assert_array_equal(tbuf.class_counts.numpy(), np.bincount(valid, minlength=N_CLS))


def batch(seed, n=10, n_classes=N_CLS):
    g = np.random.RandomState(seed)
    y = g.randint(0, n_classes, n)
    return class_images(y, g), y


def _collision_key(mem, seen, batch):
    """First key whose reservoir draws put two kept items on one slot."""
    for i in range(1000):
        key = jax.random.PRNGKey(i)
        slots = (np.asarray(jax.random.uniform(key, (batch,))) * np.float32(seen)).astype(np.int32)
        kept = slots[slots < mem]
        if len(kept) != len(set(kept.tolist())):
            return key
    raise AssertionError("no colliding key")


@pytest.mark.parametrize("case", ["fill_then_reservoir", "full_with_collision"])
def test_reservoir_update(case):
    if case == "fill_then_reservoir":
        fill, n_seen, key = 35, 35, jax.random.PRNGKey(1)
    else:
        fill, n_seen = MEM, 100
        key = _collision_key(MEM, n_seen, 10)
    jbuf, tbuf = make_buffers(MEM, fill, n_seen, seed=2)
    x, y = batch(3)
    jbuf, j_replaced = j_reservoir.reservoir_update(jbuf, jnp.asarray(x), jnp.asarray(y), key)
    u = torch.tensor(np.asarray(jax.random.uniform(key, (10,))))
    replaced = reservoir.reservoir_update(tbuf, torch.from_numpy(x), torch.from_numpy(y), u)
    np.testing.assert_array_equal(replaced.numpy(), np.asarray(j_replaced))
    assert_buffers_equal(jbuf, tbuf)
    if case == "full_with_collision":
        written = replaced.numpy()[replaced.numpy() >= 0]
        assert len(written) == len(set(written.tolist())) and len(written) > 0


@pytest.mark.parametrize("fill,k", [(40, 10), (6, 10), (0, 10)])
def test_sample_slots_and_random_retrieve(fill, k):
    jbuf, tbuf = make_buffers(MEM, fill, fill, seed=4)
    key = jax.random.PRNGKey(5)
    j_x, j_y, j_idx, j_mask = j_retrieve.random_retrieve(jbuf, k, key)
    g = torch.tensor(np.asarray(jax.random.gumbel(key, (MEM,))))
    t_x, t_y, t_idx, t_mask = retrieve.random_retrieve(tbuf, k, g)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(t_y.numpy(), np.asarray(j_y))
    np.testing.assert_array_equal(t_x.numpy(), np.asarray(j_x))


@pytest.mark.parametrize("n_smp_cls,with_excl", [(2, False), (2, True), (5, False)])
def test_class_balanced_sample(n_smp_cls, with_excl):
    jbuf, tbuf = make_buffers(MEM, MEM, 100, seed=6)
    key = jax.random.PRNGKey(7)
    excl = np.zeros(MEM, bool)
    if with_excl:
        excl[np.random.RandomState(8).choice(MEM, 15, replace=False)] = True
    j_out = j_retrieve.class_balanced_sample(
        jbuf, n_smp_cls, key, excl_mask=jnp.asarray(excl) if with_excl else None)
    g = torch.tensor(np.asarray(jax.random.gumbel(key, (N_CLS, MEM))))
    t_out = retrieve.class_balanced_sample(
        tbuf, n_smp_cls, g, excl_mask=torch.from_numpy(excl) if with_excl else None)
    for t, j in zip(t_out, j_out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_gumbel_draws_from_generator():
    a = retrieve.gumbel((1000,), torch.Generator().manual_seed(0), "cpu")
    b = retrieve.gumbel((1000,), torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert abs(a.mean().item() - 0.5772) < 0.1  # Euler–Mascheroni: the Gumbel mean
