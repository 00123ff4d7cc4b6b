"""Block FIR filtering with overlap-save state carry.

Replacement for the reference's nine convolution variants
(src/filter.cpp:96-401) and for scipy ``lfilter(..., zi=...)`` chains in the
golden models (model/fmMonoBlock.py:86-160).  One formulation covers them
all:

  * the carried state is the last ``taps-1`` *input* samples (overlap-save),
    exactly the semantics of the golden model's ``my_convoloution``
    (model/fmSupportLib.py:157-176): output-equivalent to chained
    ``scipy.signal.lfilter`` from zero initial conditions;
  * decimation fuses into the convolution as the XLA window stride
    (reference C5/C6, src/filter.cpp:126-185);
  * rational up/down resampling fuses in as lhs dilation + window stride —
    XLA's native polyphase form (reference C8/C9, src/filter.cpp:222-339);
  * the "fused" squaring/mixer variants (C10/C11, src/filter.cpp:342-401)
    need no special kernels here: elementwise pre-ops compose under jit and
    XLA fuses them into the convolution's input.

All functions are shape-polymorphic over leading batch dimensions (channels),
which is where throughput comes from: a (channels, time) batch is one big
convolution or matmul.

Two formulations, chosen per dtype by ``ops.paths.choose``: float64 runs
``lax.conv_general_dilated`` (the exact oracle path); float32 runs the
banded-Toeplitz matmul (``_conv1d_valid_matmul``) and the x-domain
polyphase resampler, or the conv, whichever measured faster on the H100
(PERF.md).  Both are exact reformulations; float32 dots run at full
float32 precision (``ops.paths.PRECISION``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from rtsdr_tpu.ops import paths
from rtsdr_tpu.ops.paths import PRECISION


def fir_zi(num_taps: int, batch_shape: tuple = (), dtype=jnp.float32) -> jax.Array:
    """Zero initial overlap-save state (last ``taps-1`` inputs)."""
    return jnp.zeros((*batch_shape, num_taps - 1), dtype=dtype)


def _as_taps(h, dtype) -> jax.Array:
    h = jnp.asarray(h)
    return h.astype(dtype)


def _conv1d_valid_xla(x: jax.Array, h: jax.Array, stride: int = 1) -> jax.Array:
    """VALID 1-D convolution via ``lax.conv_general_dilated``: exact and
    dtype-general (the float64 oracle path)."""
    batch_shape = x.shape[:-1]
    length = x.shape[-1]
    lhs = x.reshape((-1, 1, length))
    rhs = h[::-1].reshape((1, 1, h.shape[0]))
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(stride,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=PRECISION,
        preferred_element_type=x.dtype,
    )
    return out.reshape((*batch_shape, out.shape[-1]))


_MIN_BLOCK = 32


def _block_for_stride(stride: int, taps: int) -> int:
    """Outputs per matmul row-block.  The im2col windows cost
    span/(block*stride) of the input in bytes and the band wastes
    span/taps of the FLOPs (span = (block-1)*stride + taps): a block of
    about taps/stride outputs keeps both near 2x.  Blocks under
    ``_MIN_BLOCK`` outputs make dots too thin to pay for themselves: on
    the H100 the RF decimate-by-10 (151 taps, 1024 channels, 400 W) runs
    4.2 / 3.1 / 2.6 ms at 8 / 16 / 32 outputs per block (PERF.md)."""
    return max(_MIN_BLOCK, 1 << max(0, round(np.log2(taps / stride))))


def _windows(x: jax.Array, nblk: int, hop: int, span: int) -> jax.Array:
    """(..., nblk, span) overlapping windows x[s*hop : s*hop + span].

    Built from ceil(span/hop) shifted (nblk, hop) reshapes of x rather
    than nblk slices, so the op count does not grow with the block count.
    x is zero-padded on the right as far as the last slab needs.
    """
    n_slabs = -(-span // hop)
    need = (nblk + n_slabs - 1) * hop
    if need > x.shape[-1]:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, need - x.shape[-1])])
    slabs = [jax.lax.slice_in_dim(x, j * hop, (j + nblk) * hop, axis=-1)
             .reshape(*x.shape[:-1], nblk, hop) for j in range(n_slabs)]
    w = slabs[0] if n_slabs == 1 else jnp.concatenate(slabs, axis=-1)
    return w[..., :span]


def _conv1d_valid_matmul(x: jax.Array, h: jax.Array, stride: int = 1,
                         block: int | None = None) -> jax.Array:
    """VALID 1-D convolution as a dense matmul.

    Outputs are computed in blocks of B: the window spanning one block
    ((B-1)*stride + taps samples) contracts against a banded Toeplitz
    matrix H (B, span) with H[i, i*stride + j] = h_rev[j].  Exact: the
    band's zeros add nothing.
    """
    taps = h.shape[0]
    length = x.shape[-1]
    batch_shape = x.shape[:-1]
    h = h.astype(x.dtype)
    m = (length - taps) // stride + 1
    block = block or _block_for_stride(stride, taps)
    nblk = -(-m // block)
    span = (block - 1) * stride + taps
    windows = _windows(x, nblk, block * stride, span)

    h_rev = h[::-1]
    rows = jnp.arange(block)[:, None] * stride + jnp.arange(taps)[None, :]
    h_mat = jnp.zeros((block, span), h.dtype).at[
        jnp.arange(block)[:, None], rows].set(
        jnp.broadcast_to(h_rev, (block, taps)))

    y = jax.lax.dot_general(
        windows, h_mat,
        dimension_numbers=(((windows.ndim - 1,), (1,)), ((), ())),
        precision=PRECISION, preferred_element_type=x.dtype,
    )  # (..., nblk, block)
    return y.reshape((*batch_shape, nblk * block))[..., :m]


def _conv1d_valid(x: jax.Array, h: jax.Array, stride: int = 1) -> jax.Array:
    """VALID 1-D convolution (true convolution: kernel flipped) over the
    last axis, batched over all leading axes."""
    if paths.choose("fir", x.dtype) == "matmul":
        return _conv1d_valid_matmul(x, h, stride)
    return _conv1d_valid_xla(x, h, stride)


def fir_block(x: jax.Array, h, zi: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Stateful block FIR: y[n] = sum_k h[k] * xext[n + taps - 1 - k].

    Args:
      x:  (..., N) input block.
      h:  (taps,) impulse response.
      zi: (..., taps-1) previous block's input tail.

    Returns:
      y:      (..., N) filtered block (same alignment as lfilter).
      new_zi: (..., taps-1) this block's input tail.
    """
    h = _as_taps(h, x.dtype)
    xext = jnp.concatenate([zi, x], axis=-1)
    y = _conv1d_valid(xext, h)
    return y, xext[..., -(h.shape[0] - 1):]


def fir_block_bank(x: jax.Array, h_list, zi: jax.Array
                   ) -> tuple[tuple, jax.Array]:
    """``fir_block_multi`` returning a TUPLE of per-filter outputs."""
    y, new_zi = fir_block_multi(x, h_list, zi)
    return tuple(y[..., f, :] for f in range(len(h_list))), new_zi


def fir_block_multi(x: jax.Array, h_list, zi: jax.Array
                    ) -> tuple[jax.Array, jax.Array]:
    """F same-length FIRs over ONE input with ONE shared overlap-save state.

    On the matmul path one stacked banded matmul reads the input windows
    once and contracts them against all F filter matrices in a single
    dot, so filtering the demodulated stream through the pilot,
    stereo-channel and RDS-extraction band-passes reads it once, not 3x.

    Args:
      x: (..., N); h_list: sequence of (taps,) responses, equal taps.
      zi: (..., taps-1) shared input tail (all filters see the same input).

    Returns:
      y: (..., F, N); new_zi: (..., taps-1).
    """
    taps = {len(h) for h in h_list}
    assert len(taps) == 1, "fir_block_multi requires equal tap counts"
    hs = jnp.stack([_as_taps(h, x.dtype) for h in h_list])  # (F, taps)
    xext = jnp.concatenate([zi, x], axis=-1)
    new_zi = xext[..., -(hs.shape[-1] - 1):]

    if paths.choose("fir", x.dtype) == "matmul":
        return _conv1d_valid_multi_matmul(xext, hs), new_zi
    y = jnp.stack([_conv1d_valid_xla(xext, hs[f])
                   for f in range(hs.shape[0])], axis=-2)
    return y, new_zi


def _conv1d_valid_multi_matmul(xext: jax.Array, hs: jax.Array,
                               block: int | None = None) -> jax.Array:
    """F-filter VALID convolution as one stacked banded matmul.

    xext: (..., L); hs: (F, taps).  Returns (..., F, L - taps + 1)."""
    n_f, taps = hs.shape
    length = xext.shape[-1]
    batch_shape = xext.shape[:-1]
    hs = hs.astype(xext.dtype)
    m = length - taps + 1
    block = block or _block_for_stride(1, taps)
    nblk = -(-m // block)
    span = block - 1 + taps
    windows = _windows(xext, nblk, block, span)

    rows = jnp.arange(block)[:, None] + jnp.arange(taps)[None, :]
    h_rev = hs[:, ::-1]
    h_mat = jnp.zeros((n_f, block, span), hs.dtype).at[
        :, jnp.arange(block)[:, None], rows].set(
        jnp.broadcast_to(h_rev[:, None, :], (n_f, block, taps)))
    h_flat = h_mat.reshape(n_f * block, span)

    y = jax.lax.dot_general(
        windows, h_flat,
        dimension_numbers=(((windows.ndim - 1,), (1,)), ((), ())),
        precision=PRECISION, preferred_element_type=xext.dtype,
    )  # (..., nblk, F*block)
    y = y.reshape((*batch_shape, nblk, n_f, block))
    y = jnp.moveaxis(y, -2, -3)  # (..., F, nblk, block)
    return y.reshape((*batch_shape, n_f, nblk * block))[..., :m]


def fir_decimate(x: jax.Array, h, zi: jax.Array,
                 decim: int) -> tuple[jax.Array, jax.Array]:
    """Fused FIR + downsample-by-``decim``: computes only the kept outputs.

    Equivalent to ``lfilter(h, 1, x, zi)[::decim]`` (golden model
    model/fmMonoBlock.py:86-105) but never materializes the dropped samples
    (reference C5, src/filter.cpp:126-154).
    """
    h = _as_taps(h, x.dtype)
    xext = jnp.concatenate([zi, x], axis=-1)
    y = _conv1d_valid(xext, h, stride=decim)
    return y, xext[..., -(h.shape[0] - 1):]


def _upsampled_tail_of(x: jax.Array, n_tail: int, up: int) -> jax.Array:
    """Last ``n_tail`` samples of zero-stuff(x, up), without materializing."""
    k = -(-n_tail // up)
    xt = x[..., -k:]
    u = jnp.pad(xt[..., None], [(0, 0)] * xt.ndim + [(0, up - 1)])
    return u.reshape(*xt.shape[:-1], k * up)[..., -n_tail:]


def _resample_boundary_index(t1: int, up: int, down: int
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Index math for the resampler's carried-state boundary matmul.

    The first ceil(t1/down) outputs also read the carried upsampled-
    domain tail: output r takes tap kz = r*down + t1 - j from zi position
    j where valid.  Returns (kz clipped to [0, t1], valid mask), both
    (ceil(t1/down), t1) numpy arrays.
    """
    nb = -(-t1 // down)
    rz = np.arange(nb)[:, None]
    j = np.arange(t1)[None, :]
    kz = rz * down + t1 - j
    valid = (j >= rz * down) & (kz >= 0) & (kz <= t1)
    return np.clip(kz, 0, t1), valid


def _resample_polyphase_matmul(x: jax.Array, h: jax.Array, zi: jax.Array,
                               up: int, down: int, block: int | None = None
                               ) -> tuple[jax.Array, jax.Array]:
    """Rational resampler without the upsampled-domain buffer.

    Exact reformulation of ``y[m] = sum_k h[k] * uext[m*down + taps-1 - k]``
    (uext = [zi | zero-stuff(x, up)]) in the x domain:

        y[m] = sum_i h[m*down + taps-1 - i*up] * x[i]   (+ zi boundary terms)

    Output blocks of B (up | B*down/up alignment) contract x windows against
    a phase-banded matrix H[r, t] = h[r*down + taps-1 - t*up] — the same
    matmul shape as ``_conv1d_valid_matmul`` but with only the ~taps/up
    genuinely contributing taps per output, so nothing upsampled is ever
    materialized.
    """
    taps = h.shape[0]
    t1 = taps - 1
    n = x.shape[-1]
    batch = x.shape[:-1]
    assert (n * up) % down == 0
    m_total = n * up // down

    # B: a multiple of up so every block starts at phase 0, sized like
    # _block_for_stride on the x-domain stride down/up with taps/up taps
    b = block or up * max(1, round(_block_for_stride(down, taps) / up))
    nblk = -(-m_total // b)
    stride_x = b * down // up
    # output r in a block reads x[i] for (r*down - t1)/up <= i <= r*down/up;
    # the window leads the block's x origin by g = ceil(t1/up) samples
    # (left region j < t1 belongs to zi, handled below; left-pad zeros here)
    g = -(-t1 // up)
    span = (b - 1) * down // up + g + 1
    x_pad = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(g, 0)])
    windows = _windows(x_pad, nblk, stride_x, span)

    r = np.arange(b)[:, None]
    t = np.arange(span)[None, :]
    k = r * down + g * up - t * up  # h index for x[i = s*stride_x - g + t]
    valid = (k >= 0) & (k <= t1)
    # indices/masks are compile-time numpy; h may be traced
    h_mat = jnp.where(jnp.asarray(valid),
                      h[jnp.asarray(np.clip(k, 0, t1))],
                      0.0).astype(x.dtype)

    y = jax.lax.dot_general(
        windows, h_mat,
        dimension_numbers=(((windows.ndim - 1,), (1,)), ((), ())),
        precision=PRECISION, preferred_element_type=x.dtype,
    ).reshape(*batch, nblk * b)[..., :m_total]

    # boundary: the first ceil(t1/down) outputs also read the carried zi
    kz, validz = _resample_boundary_index(t1, up, down)
    nb = kz.shape[0]
    hz = jnp.where(jnp.asarray(validz),
                   h[jnp.asarray(kz)], 0.0).astype(x.dtype)
    y_zi = jax.lax.dot_general(
        zi, hz, dimension_numbers=(((zi.ndim - 1,), (1,)), ((), ())),
        precision=PRECISION, preferred_element_type=x.dtype)
    y = y.at[..., :nb].add(y_zi)

    new_zi = _upsampled_tail_of(x, t1, up)
    return y, new_zi


def fir_resample(x: jax.Array, h, zi: jax.Array, up: int, down: int,
                 gain: float | None = None) -> tuple[jax.Array, jax.Array]:
    """Fused rational resampler: zero-stuff x``up``, FIR, keep every ``down``-th.

    Matches the golden model's explicit pipeline (model/fmRDSblock.py:184-199):
    upsample by ``up``, anti-image ``lfilter(h, zi)``, ``[::down] * up``.
    Two exact forms, chosen by ``ops.paths.choose('resample', dtype)``:
    the x-domain polyphase matmul (never builds the zero-stuffed stream,
    only the ~taps/up contributing taps per output) and the dilated conv
    over the zero-stuffed stream (the float64 oracle), replacing the
    reference's hand-strided tap loop (C8, src/filter.cpp:235-244).

    ``zi`` lives in the *upsampled* domain: shape (..., taps-1), carrying the
    tail of the zero-stuffed stream, so outputs are bit-identical to the
    golden model's chained lfilter.  ``gain`` defaults to ``up`` (Parseval
    compensation, reference C9 src/filter.cpp:333).
    """
    if gain is None:
        gain = float(up)

    if up == 1:
        y, new_zi = fir_decimate(x, h, zi, down)
        if gain == 1.0:
            return y, new_zi
        return y * jnp.asarray(gain, x.dtype), new_zi

    h = _as_taps(h, x.dtype)
    taps = h.shape[0]
    n = x.shape[-1]
    batch = x.shape[:-1]

    if paths.choose("resample", x.dtype) == "polyphase":
        y, new_zi = _resample_polyphase_matmul(x, h, zi, up, down)
        return y * jnp.asarray(gain, x.dtype), new_zi

    # uext = [zi (taps-1, upsampled domain) | zero-stuff(x, up) (n*up)];
    # y[j] = sum_k h[k] uext[j*down + taps-1 - k].  Zero-stuffing is a
    # pad + reshape (contiguous), not a strided scatter.
    u = jnp.pad(x[..., None], [(0, 0)] * x.ndim + [(0, up - 1)])
    u = u.reshape(*batch, n * up)
    uext = jnp.concatenate([zi, u], axis=-1)
    y = _conv1d_valid_xla(uext, h, stride=down)
    new_zi = uext[..., -(taps - 1):]
    return y * jnp.asarray(gain, x.dtype), new_zi


def resample_zi(num_taps: int, batch_shape: tuple = (),
                dtype=jnp.float32) -> jax.Array:
    """Zero initial state for ``fir_resample`` (upsampled-domain tail)."""
    return jnp.zeros((*batch_shape, num_taps - 1), dtype=dtype)
