"""Critically-sampled polyphase filter-bank (PFB) channelizer.

Beyond the reference (which tunes ONE station per dongle pipe,
src/fm_radio.cpp:31-147): split one wideband IQ capture into K
frequency channels, each downconverted to complex baseband and decimated
by K — the K-station front door for the batched receiver.

Math.  Channel k = ``decimate_K(LPF(x[t] * exp(-2j*pi*k*t/K)))`` with a
shared prototype low-pass ``h``.  Substituting n = j*K + p gives the
polyphase form

    y[m, k] = sum_p exp(+2j*pi*k*p/K) * u_p[m]
    u_p[m]  = sum_j h[j*K + p] * x[m*K - p - j*K]

i.e. per-phase FIR over the decimated phase planes followed by a length-K
inverse DFT across phases — ``K * ifft(u, axis=phase)``.  The phase-plane
construction is one pad + reshape + flip (no gathers), the branch FIR is
a t-term FMA chain over (M, K) planes, and the IDFT is a tiny batched
FFT.

The raw-byte paths (``pfb_channelize_u8``, ``composed_channelize_u8``)
run their banded matmul on float32 operands at full float32 precision
(``ops.paths.PRECISION``): the byte normalization (b - 128)/128 is exact
in float32, and a TF32 or bf16 operand would put a ~1e-3 relative error
on every station before its RF filter (NUMERICS.md).

Streaming: the carried state is the last ``t*K + K - 1`` input samples
(the phase-plane window tail), so chained blocks are exactly equal to one
long call (tested).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from rtsdr_tpu.ops.coeffs import lowpass_taps
from rtsdr_tpu.ops.paths import PRECISION


def channelizer_taps(n_channels: int, taps_per_branch: int = 16,
                     cutoff_frac: float = 0.45) -> np.ndarray:
    """Prototype low-pass for a K-channel PFB.

    cutoff = cutoff_frac * (fs / K): 0.45 leaves a guard band between
    adjacent 1/K-wide slots; the per-station RF LPF downstream does the
    tight selectivity.
    """
    k = n_channels
    taps = taps_per_branch * k
    return lowpass_taps(1.0, cutoff_frac / k, taps)


def channelizer_zi(n_channels: int, taps: int, batch_shape: tuple = (),
                   dtype=jnp.complex64) -> jax.Array:
    """Zero initial state: the carried input tail."""
    t = -(-taps // n_channels)  # taps per branch (ceil)
    return jnp.zeros((*batch_shape, t * n_channels + n_channels - 1), dtype)


def pfb_channelize(
    x: jax.Array,
    h,
    zi: jax.Array,
    n_channels: int,
) -> tuple[jax.Array, jax.Array]:
    """Channelize complex x (..., N) -> (..., M, K), M = N/K.

    Output m, k is exactly ``sum_n h[n] x_ext[L + m*K - n] * W(k, n)``
    with W the downconversion twiddle — equal to mix->lfilter->[::K] of
    the concatenated stream (oracle-tested; lfilter alignment: output
    sample m corresponds to input index m*K).
    """
    k = n_channels
    h = jnp.asarray(h)
    taps = h.shape[0]
    t = -(-taps // k)
    if taps < t * k:  # pad the prototype to a whole number of branches
        h = jnp.pad(h, (0, t * k - taps))
    n = x.shape[-1]
    assert n % k == 0, "block length must divide by n_channels"
    m_out = n // k
    batch = x.shape[:-1]
    l_zi = t * k + k - 1
    assert zi.shape[-1] == l_zi

    x_ext = jnp.concatenate([zi.astype(x.dtype), x], axis=-1)
    # Phase planes v[r, p] = x_ext[(r+2)K - 1 - p], one reshape + flip
    # (no gathers).  The base offset K keeps output m on the K-grid of
    # the stream: u[m, p] below reads x_ext[a + (m+t-1)K - n] with
    # a = 2K-1, and stream position = that - len(zi) = m*K - n — exactly
    # lfilter(h, 1, mix(x))[::K] sample m.
    rows = (x_ext.shape[-1] - k) // k
    v = x_ext[..., k:k + rows * k].reshape(*batch, rows, k)[..., ::-1]
    # u[m, p] = sum_j h[jK + p] v[m + t - 1 - j, p]
    h_b = h.reshape(t, k)  # h_b[j, p] = h[jK + p]
    u = jnp.zeros((*batch, m_out, k), x.dtype)
    for j in range(t):
        w = v[..., t - 1 - j: t - 1 - j + m_out, :]
        u = u + w * h_b[j].astype(x.dtype)
    y = k * jnp.fft.ifft(u, axis=-1)

    new_zi = x_ext[..., -l_zi:]
    return y.astype(x.dtype), new_zi.astype(zi.dtype)


def channelizer_zi_u8(n_channels: int, taps: int,
                      batch_shape: tuple = ()) -> jax.Array:
    """Zero initial state for the raw-byte path: value-128 bytes
    (normalize to 0 — equal to the complex path's zero tail)."""
    t = -(-taps // n_channels)
    l_zi = t * n_channels + n_channels - 1
    return jnp.full((*batch_shape, 2 * l_zi), 128, jnp.uint8)


def pfb_channelize_u8(
    raw_u8: jax.Array,
    h,
    zi_raw: jax.Array,
    n_channels: int,
    block: int = 16,
) -> tuple[jax.Array, jax.Array]:
    """K-channel PFB straight from interleaved uint8 IQ bytes.

    The mix + prototype LPF + decimate-by-K for ALL K channels and both
    quadratures is ONE banded matmul over the raw byte stream: the
    length-K inverse DFT across polyphase branches folds into the
    filter matrix (channel k's complex taps are h[n]*exp(2j*pi*n*k/K)),
    and the (b-128)/128 normalization folds into the matrix values, so
    neither a float copy of the wideband stream, nor phase planes, nor
    any complex intermediate ever materializes.  Output-equivalent to
    normalize -> complex -> ``pfb_channelize`` (float32 rounding only;
    the t-term complex FMA chain of that path re-reads its (M, K)
    planes t times).

    raw_u8: (..., 2*N) interleaved IQ; zi_raw: (..., 2*(t*K + K - 1))
    carried byte tail (prepend-halo streaming; start from
    ``channelizer_zi_u8``).  Returns ((..., K, 2, M) float32 stacked
    I/Q at the channel rate — the receivers' 'iq' frontend input — and
    the new byte tail).
    """
    k = n_channels
    h64 = np.asarray(h, np.float64)
    taps = h64.shape[0]
    t = -(-taps // k)
    if taps < t * k:
        h64 = np.pad(h64, (0, t * k - taps))
    l_zi = t * k + k - 1
    assert zi_raw.shape[-1] == 2 * l_zi
    n = raw_u8.shape[-1] // 2
    assert n % k == 0
    m_out = n // k
    assert m_out % block == 0, "use pfb_channelize for ragged lengths"
    assert t <= block + 1, "window must fit two stride slabs"
    nblk = m_out // block
    batch = raw_u8.shape[:-1]
    span = 2 * k * (block - 1 + t)
    stride = 2 * k * block

    # right-pad so both slabs reshape exactly (value 128 -> 0, and the
    # pad rows multiply zero filter-matrix entries anyway); folding the
    # pad into the zi concat keeps this to ONE copy of the stream
    need = 2 * k + (nblk + 1) * stride
    pad_n = max(0, need - 2 * l_zi - raw_u8.shape[-1])
    x_ext = jnp.concatenate(
        [zi_raw, raw_u8] + ([jnp.full((*batch, pad_n), 128, jnp.uint8)]
                            if pad_n else []), axis=-1)

    def norm(b):
        return (b.astype(jnp.float32) - 128.0) * (1.0 / 128.0)

    # windows[s] = x_ext[2k + s*stride : + span]: span <= 2*stride, so
    # two shifted stride-row slabs cover every window — the per-block
    # stack-of-slices form emits thousands of slice ops at these block
    # counts (nblk ~ 1e4 at production widths) and dominated the step
    def slab(off):
        sl = jax.lax.slice_in_dim(x_ext, off, off + nblk * stride, axis=-1)
        return norm(sl).reshape(*batch, nblk, stride)

    windows = jnp.concatenate(
        [slab(2 * k), slab(2 * k + stride)[..., :span - stride]], axis=-1)

    # H[byte, col(i, ch, quad)]: output i of a block, channel ch, reads
    # x_ext complex idx (i+t)*K - 1 - n_tap (rel. block window) with
    # complex coefficient c = h[n_tap] * exp(2j*pi*n_tap*ch/K):
    #   y_re = sum re(c)*x_re - im(c)*x_im ; y_im = sum im(c)*x_re + re(c)*x_im
    i_idx = np.arange(block)[:, None]
    n_idx = np.arange(t * k)[None, :]
    r_even = 2 * ((i_idx + t) * k - 1 - n_idx)  # (block, t*k) byte rows
    h_mat = np.zeros((span, block * k * 2), np.float64)
    for ch in range(k):
        c = h64 * np.exp(2j * np.pi * n_idx[0] * ch / k)
        cr = np.broadcast_to(c.real, r_even.shape)
        ci = np.broadcast_to(c.imag, r_even.shape)
        col_re = np.broadcast_to(ch * 2 * block + i_idx, r_even.shape)
        rs = r_even.ravel()
        h_mat[rs, col_re.ravel()] = cr.ravel()
        h_mat[rs + 1, col_re.ravel()] = -ci.ravel()
        h_mat[rs, col_re.ravel() + block] = ci.ravel()
        h_mat[rs + 1, col_re.ravel() + block] = cr.ravel()
    y = jax.lax.dot_general(
        windows, jnp.asarray(h_mat, jnp.float32),
        dimension_numbers=(((windows.ndim - 1,), (0,)), ((), ())),
        precision=PRECISION,
        preferred_element_type=jnp.float32)  # (..., nblk, K*2*block)
    y = y.reshape(*batch, nblk, k, 2, block)
    y = jnp.moveaxis(y, -4, -2)             # (..., K, 2, nblk, block)
    y = y.reshape(*batch, k, 2, m_out)
    assert n >= l_zi
    return y, raw_u8[..., -2 * l_zi:]


def composed_rf_taps(
    n_channels: int,
    h_proto,
    h_rf,
    decim: int,
    offsets_hz=None,
    fs_ch: float | None = None,
) -> np.ndarray:
    """Compose channelizer slot k + the per-station RF decimating LPF
    into one complex FIR per station, straight at the wideband rate.

    Both stages are LTI decimating FIRs, so the cascade
    ``decimate_10(h_rf * decimate_K(h_ch^(k) * x))`` is EXACTLY one
    decimate-by-``10K`` FIR with taps

        g_k[t] = sum_j h_rf[j] * h_ch^(k)[t - j*K],
        h_ch^(k)[n] = h_ch[n] * exp(2j*pi*k*n/K)

    (i.e. ``conv(upsample_K(h_rf), h_ch^(k))``).  This is the wideband
    analogue of the mono chain's fused uint8 ingest: the reference runs
    its RF front end once per retuned dongle (src/fm_radio.cpp:31-147);
    here ALL K stations' front ends and the channelizer are one filter
    bank — no channel-rate intermediate (at K=16/B=8 production widths
    the two-stage path writes, re-reads and transposes a 157 MB float
    plane).

    ``offsets_hz`` (length K, off-grid stations): mixing between the
    stages commutes into the composition exactly —
    ``mix(theta) -> h_rf`` equals ``(h_rf[j] * exp(-1j*step*j)) ->
    post-mix exp(1j*theta(decim*p))`` — so the residual NCO moves to
    the IF rate (10x fewer samples); apply the post-mix with
    ``step_k = -2*pi*offsets_hz[k]/fs_ch`` per IF sample times
    ``decim`` (see pipeline/wideband.py).

    Returns (K, L) complex128, L = (len(h_rf)-1)*K + len(h_ch_padded).
    """
    k = n_channels
    h64 = np.asarray(h_proto, np.float64)
    t = -(-len(h64) // k)
    if len(h64) < t * k:
        h64 = np.pad(h64, (0, t * k - len(h64)))
    h_rf = np.asarray(h_rf, np.float64)
    j_idx = np.arange(len(h_rf), dtype=np.float64)
    n_idx = np.arange(t * k, dtype=np.float64)
    g = []
    for ch in range(k):
        h_rf_k = h_rf.astype(np.complex128)
        if offsets_hz is not None and offsets_hz[ch]:
            assert fs_ch is not None
            step = -2.0 * np.pi * float(offsets_hz[ch]) / fs_ch
            h_rf_k = h_rf_k * np.exp(-1j * step * j_idx)
        up = np.zeros(((len(h_rf) - 1) * k + 1), np.complex128)
        up[::k] = h_rf_k
        h_chk = h64 * np.exp(2j * np.pi * n_idx * ch / k)
        g.append(np.convolve(up, h_chk))
    return np.stack(g)


def composed_zi_u8(g_len: int, batch_shape: tuple = ()) -> jax.Array:
    """Zero history for the composed path: value-128 bytes for the last
    L-1 complex wideband samples."""
    return jnp.full((*batch_shape, 2 * (g_len - 1)), 128, jnp.uint8)


def composed_channelize_u8(
    raw_u8: jax.Array,
    g: np.ndarray,
    zi_raw: jax.Array,
    decim: int,
    block: int = 16,
) -> tuple[jax.Array, jax.Array]:
    """K stations' channelizer + RF front-end LPF + decimate in ONE
    banded matmul over the raw wideband bytes.

    ``g``: (K, L) complex taps from ``composed_rf_taps``.  Output p of
    station ch is ``sum_t g[ch, t] * X[decim*K*p - t]`` with X the
    normalized complex stream — bitwise the same recurrence as
    channelize -> ``ops.fir.fir_decimate`` in exact arithmetic (f32/bf16
    rounding only; parity-tested against the two-stage path).

    raw_u8: (..., 2*N) interleaved uint8 at ``fs_w = K*fs``;
    zi_raw: (..., 2*(L-1)) carried byte tail.  Returns
    ((..., K, 2, P) float32 decimated station I/Q at the IF rate,
    P = N/(decim*K), and the new byte tail) — feed receivers built with
    ``frontend_impl='if'``.
    """
    k, g_l = g.shape
    d = decim * k                       # complex samples per output
    assert zi_raw.shape[-1] == 2 * (g_l - 1)
    n = raw_u8.shape[-1] // 2
    assert n % d == 0
    p_out = n // d
    assert p_out % block == 0, "P must divide the output block"
    span_c = d * (block - 1) + g_l      # complex window per output block
    stride_b = 2 * d * block
    span_b = 2 * span_c
    n_slabs = -(-span_b // stride_b)
    assert n_slabs <= 3, "window too long for the slab construction"
    nblk = p_out // block
    batch = raw_u8.shape[:-1]

    need = n_slabs * stride_b + (nblk - 1) * stride_b
    pad_n = max(0, need - (zi_raw.shape[-1] + raw_u8.shape[-1]))
    x_ext = jnp.concatenate(
        [zi_raw, raw_u8] + ([jnp.full((*batch, pad_n), 128, jnp.uint8)]
                            if pad_n else []), axis=-1)

    def norm(b):
        return (b.astype(jnp.float32) - 128.0) * (1.0 / 128.0)

    def slab(off):
        sl = jax.lax.slice_in_dim(x_ext, off, off + nblk * stride_b,
                                  axis=-1)
        return norm(sl).reshape(*batch, nblk, stride_b)

    windows = jnp.concatenate(
        [slab(0)] + [slab(i * stride_b)[..., :min(stride_b,
                                                  span_b - i * stride_b)]
                     for i in range(1, n_slabs)], axis=-1)

    # H[byte, col(ch, quad, i)]: output i reads complex window offset
    # o = d*i + (L-1) - t for tap t (bijective in t per column)
    i_idx = np.arange(block)[:, None]
    t_idx = np.arange(g_l)[None, :]
    o = d * i_idx + (g_l - 1) - t_idx          # (block, L) complex rows
    h_mat = np.zeros((span_b, block * k * 2), np.float64)
    for ch in range(k):
        c = g[ch]                               # (L,)
        cr = np.broadcast_to(c.real, o.shape)
        ci = np.broadcast_to(c.imag, o.shape)
        col_re = np.broadcast_to(ch * 2 * block + i_idx, o.shape)
        rs = 2 * o.ravel()
        h_mat[rs, col_re.ravel()] = cr.ravel()
        h_mat[rs + 1, col_re.ravel()] = -ci.ravel()
        h_mat[rs, col_re.ravel() + block] = ci.ravel()
        h_mat[rs + 1, col_re.ravel() + block] = cr.ravel()
    y = jax.lax.dot_general(
        windows, jnp.asarray(h_mat, jnp.float32),
        dimension_numbers=(((windows.ndim - 1,), (0,)), ((), ())),
        precision=PRECISION,
        preferred_element_type=jnp.float32)     # (..., nblk, K*2*block)
    y = y.reshape(*batch, nblk, k, 2, block)
    y = jnp.moveaxis(y, -4, -2)                 # (..., K, 2, nblk, block)
    y = y.reshape(*batch, k, 2, p_out)
    assert n >= g_l - 1
    return y, raw_u8[..., -2 * (g_l - 1):]


def channel_center_freqs(n_channels: int, fs: float) -> np.ndarray:
    """Center frequency of each output channel (Hz), wrapped to +-fs/2."""
    k = np.arange(n_channels)
    f = k * fs / n_channels
    return np.where(f >= fs / 2, f - fs, f)
