"""Kernel 3 (int_attention) beyond the shared-memory limit of its resident
form: the plain version the kernel is held to on the card equals the JAX
package's XLA composition (qasr_tpu/quantize/conformer_freeze.py, the
branch it takes above its Pallas kernel's 2,048 frames) at a T where the
kernel takes its streaming form, with ragged lengths, with and without a
context window.  A few heads and a small d_k keep it cheap on the CPU.
Tolerance: exact."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_tpu.models.conformer import attention_mask
from qasr_tpu.ops.integer_softmax import i_softmax_grid
from qasr_tpu.ops.quant_prims import dyadic_requant_static
from qasr_tpu_torch.kernels import int_attention as port_att

AC, BD, CTX = (2**30 + 17, 33), (2**30 - 5, 33), (2**30 + 3, 38)


@functools.partial(jax.jit, static_argnames=("ctx", "nbits"))
def jax_attention(qu, qv, k, v, p, lens, ctx, nbits=8):
    """conformer_freeze.py's XLA composition of the attention core."""
    b, t, h, d_k = qu.shape
    n = 2 ** (nbits - 1) - 1
    valid = jnp.arange(t)[None, :] < lens[:, None]
    att_mask = attention_mask(valid, ctx)
    ac = jnp.einsum("bihd,bjhd->bhij", qu, k, preferred_element_type=jnp.int32)
    bd_full = jnp.einsum("bihd,phd->bhip", qv, p, preferred_element_type=jnp.int32)
    idx = (t - 1) + np.arange(t)[:, None] - np.arange(t)[None, :]
    bd = jnp.take_along_axis(bd_full, jnp.asarray(idx)[None, None], axis=-1)
    q_grid = (dyadic_requant_static(ac, jnp.asarray(AC[0]), AC[1])
              + dyadic_requant_static(bd, jnp.asarray(BD[0]), BD[1]))
    a8 = i_softmax_grid(q_grid, mask=att_mask[:, None], out_bits=nbits).astype(jnp.int8)
    out = jnp.einsum("bhij,bjhd->bihd", a8, v, preferred_element_type=jnp.int32
                     ).reshape(b, t, h * d_k)
    return jnp.clip(dyadic_requant_static(out, jnp.asarray(CTX[0]), CTX[1]),
                    -n, n - 1).astype(jnp.int8)


@pytest.mark.parametrize("ctx", [(-1, -1), (64, 16)])
def test_int_attention_plain_matches_xla_above_old_limit(ctx):
    b, t, h, d_k = 2, 1300, 2, 8
    assert not port_att.resident(t, d_k), "T must be above the resident form's limit"
    rng = np.random.default_rng(1300 + ctx[0])
    qu, qv, k, v = (rng.integers(-127, 127, (b, t, h, d_k)).astype(np.int8) for _ in range(4))
    p = rng.integers(-127, 127, (2 * t - 1, h, d_k)).astype(np.int8)
    lens = np.asarray([t, 977], np.int32)
    want = np.asarray(jax_attention(*(jnp.asarray(a) for a in (qu, qv, k, v, p)),
                                    jnp.asarray(lens), ctx=ctx))
    got = port_att.int_attention(*(torch.from_numpy(a) for a in (qu, qv, k, v, p)),
                                 torch.from_numpy(lens), ac=AC, bd=BD, ctx_rq=CTX,
                                 left=ctx[0], right=ctx[1], nbits=8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 8, "degenerate context"


def test_resident_form_limit():
    """The flagship's serving T keeps the resident form; the JAX package's
    Pallas range (T <= 2,048) and beyond take the streaming form, which has
    no length limit (the wrapper no longer raises)."""
    assert port_att.resident(375, 64)
    for t in (1300, 2048, 2600, 10_000):
        assert not port_att.resident(t, 64)
