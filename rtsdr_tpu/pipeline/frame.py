"""RDS bit layer: clock recovery, Manchester + differential decode, frame sync.

Replaces the reference frame_thread (src/fm_radio.cpp:444-729) following the
golden model (model/fmRDSblock.py:206-347).  Everything is fixed-shape
(padded arrays + carried counts) so the whole layer jits; the per-block
symbol/bit counts vary by +-1 with the clock offset (SURVEY.md §7 hard part
#3).

The 26x10 GF(2) parity multiply that the reference does as a triple loop per
bit position (src/fm_radio.cpp:631-646) is one batched int32 matmul over all
window positions at once, followed by ``& 1``.

Stage-by-stage golden parity notes:
  * clock recovery: block-0 offset = argmax of the first 24 RRC samples
    (signed, as the model; the C++ uses abs) — ``use_abs_clock`` selects.
  * offset update: ``offset_mode='track'`` reproduces the model's per-block
    update (model/fmRDSblock.py:219) exactly, via the closed form
    ``24 + R - offset - 24*n_sym`` (the model finds the same value by
    searching the last 24 samples for the last symbol).  ``'hold'`` keeps
    the initial offset — with ``R % 24 == 0`` the offset never drifts, which
    is why the C++ disabled the update (src/fm_radio.cpp:529-538) and got
    more syndromes; 'hold' is the default.
  * frame sync: the model re-evaluates each block's last window as the next
    block's first window at the same global position (its carry is 27 bits,
    model/fmRDSblock.py:346); we reproduce that, including the resulting
    duplicate/false-positive report at seams.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rtsdr_tpu.config import ReceiverConfig
from rtsdr_tpu.ops.paths import PRECISION

# RDS parity-check matrix H (26 x 10) over GF(2) and the four offset-word
# syndromes, from the RDS standard (as used at model/fmRDSblock.py:50 and
# src/fm_radio.cpp:477-482).  Layout: first 10 rows identity (checkword),
# last 16 rows the info-word parity contribution.
_H_LOWER = [
    [1, 0, 1, 1, 0, 1, 1, 1, 0, 0],
    [0, 1, 0, 1, 1, 0, 1, 1, 1, 0],
    [0, 0, 1, 0, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 0, 0, 0, 1, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 1, 1, 1],
    [1, 1, 0, 0, 0, 1, 0, 0, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1],
    [1, 1, 0, 1, 1, 1, 0, 1, 1, 0],
    [0, 1, 1, 0, 1, 1, 1, 0, 1, 1],
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 1],
    [1, 1, 1, 1, 0, 1, 1, 1, 0, 0],
    [0, 1, 1, 1, 1, 0, 1, 1, 1, 0],
    [0, 0, 1, 1, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 1, 0, 0, 1, 1, 1],
    [1, 1, 1, 0, 0, 0, 1, 1, 1, 1],
    [1, 1, 0, 0, 0, 1, 1, 0, 1, 1],
]
H_MATRIX = np.concatenate([np.eye(10, dtype=np.int32),
                           np.array(_H_LOWER, dtype=np.int32)])

SYNDROMES = np.array(
    [
        [1, 1, 1, 1, 0, 1, 1, 0, 0, 0],  # A
        [1, 1, 1, 1, 0, 1, 0, 1, 0, 0],  # B
        [1, 0, 0, 1, 0, 1, 1, 1, 0, 0],  # C
        [1, 0, 0, 1, 0, 1, 1, 0, 0, 0],  # D
        [1, 1, 1, 1, 0, 0, 1, 1, 0, 0],  # C' (offset word 0b1101010000)
    ],
    dtype=np.int32,
)
SYNDROME_NAMES = ["A", "B", "C", "D", "C'"]

CARRY_BITS = 27  # model/fmRDSblock.py:346 carries position-1 onward

_BURST_SPAN = 5  # the (26,16) shortened cyclic code corrects <=5-bit bursts


def _burst_table() -> tuple[np.ndarray, np.ndarray]:
    """Syndrome -> burst-error lookup for the RDS (26,16) code.

    Every burst of span <= 5 inside the 26-bit block maps to a UNIQUE
    nonzero 10-bit syndrome under H (367 patterns, zero collisions —
    asserted here at build time), so correction is one table lookup off
    the syndrome the frame layer already computes.  The reference only
    *detects* (src/fm_radio.cpp:631-646); IEC 62106 annex B specifies
    exactly this burst-correction capability.

    Returns (corr_flag, err_info, err_span): ``corr_flag[s]`` = 1 if
    syndrome ``s`` is a correctable burst, ``err_info[s]`` = the 16 info
    bits of the error pattern (to XOR onto the received info word),
    ``err_span[s]`` = the burst's span in bits (1..5; 0 where not
    correctable).  Check-bit error bits need no repair — the payload is
    only the info word.  The span disambiguates between offset words:
    the table covers ~36% of the 10-bit syndrome space, so a genuinely
    corrupted block usually hits it for a WRONG offset too — but chance
    hits are overwhelmingly long bursts (268/367 entries have span >= 4)
    while real click/noise errors are short, so "smallest span wins,
    ties reject" keeps nearly all true repairs and almost no false ones.
    """
    pow2 = 1 << np.arange(9, -1, -1)
    corr_flag = np.zeros(1024, np.int32)
    err_info = np.zeros(1024, np.int32)
    err_span = np.zeros(1024, np.int32)
    for span in range(1, _BURST_SPAN + 1):
        for start in range(0, 26 - span + 1):
            for inter in [0] if span <= 2 else range(1 << (span - 2)):
                bits = np.zeros(26, np.int64)
                bits[start] = 1
                if span >= 2:
                    bits[start + span - 1] = 1
                for k in range(span - 2):
                    bits[start + 1 + k] = (inter >> k) & 1
                s = int(((bits @ H_MATRIX) % 2) @ pow2)
                assert s != 0 and not corr_flag[s], "burst syndromes collide"
                corr_flag[s] = 1
                err_info[s] = int(bits[:16] @ (1 << np.arange(15, -1, -1)))
                err_span[s] = span
    return corr_flag, err_info, err_span

def _gardner_ted_slope(sps: int, rrc: np.ndarray) -> float:
    """Expected Gardner TED S-curve slope (error units per sample of
    timing offset) for Manchester chips matched-filtered by ``rrc``.

    Derivation: the receiver chip stream is y(t) = sum_m c_m g(t - m*sps)
    with g = rrc (tx) convolved with rrc (rx) and Manchester chip
    correlation R(m,m)=1, R(2k,2k+1)=-1, else 0 (chips within one bit are
    always opposite; distinct bits are independent).  The detector error
    e(tau) = E[mid*(sym_n - sym_{n-1})]/E[sym^2] then has a closed form in
    g, evaluated here on the integer sample grid and differenced at
    tau=+-1; verified against brute-force simulation (the two agree to
    <1%, and 1/slope = 5.87 for the mode-0 RRC matches the round-3
    empirically-calibrated 6.0 this replaces).
    """
    g = np.convolve(rrc, rrc)
    c = len(g) // 2
    m_max = (c // sps) + 2

    def corr(t1: int, t2: int) -> float:
        s = 0.0
        for m in range(-m_max, m_max):
            tm, tn = t1 - m * sps, t2 - m * sps
            if abs(tm) <= c and abs(tn) <= c:
                s += g[c + tm] * g[c + tn]
        for k in range(-m_max // 2 - 1, m_max // 2 + 1):
            for p, q in ((2 * k, 2 * k + 1), (2 * k + 1, 2 * k)):
                tp, tq = t1 - p * sps, t2 - q * sps
                if abs(tp) <= c and abs(tq) <= c:
                    s -= g[c + tp] * g[c + tq]
        return s

    def e_of_tau(tau: int) -> float:
        num = den = 0.0
        half = sps // 2
        for n0 in (0, 1):   # chip-parity average (Manchester is period-2)
            t_sym = n0 * sps + tau
            t_prev = (n0 - 1) * sps + tau
            t_mid = n0 * sps - half + tau
            num += corr(t_mid, t_sym) - corr(t_mid, t_prev)
            den += corr(t_sym, t_sym)
        return num / den

    return (e_of_tau(1) - e_of_tau(-1)) / 2.0


def gardner_gain(cfg: ReceiverConfig) -> float:
    """Deadbeat Gardner loop gain 1/slope: one block's averaged error maps
    to the full offset correction in samples (the per-block step is then
    clipped to +-1 sample by the loop).  Replaces the round-3 magic 6.0,
    which was calibrated empirically on the synthetic multiplex — the
    derived value (5.87 for mode 0) reproduces it and now tracks the
    configured sps / RRC beta instead of silently going stale with them.
    """
    from rtsdr_tpu.ops.coeffs import rrc_taps
    r = cfg.rds
    rrc = np.asarray(rrc_taps(r.rrc_fs, r.rrc_taps, r.rrc_beta,
                              r.symbol_rate), np.float64)
    return float(1.0 / _gardner_ted_slope(r.sps, rrc))


class FrameState(NamedTuple):
    offset: jax.Array        # int32 clock offset into the RRC block
    start_pos: jax.Array     # int32 0/1 Manchester phase
    lonely_bit: jax.Array    # float last unpaired symbol (start_pos=1 carry)
    prebit: jax.Array        # int32 differential-decode carry
    first_block: jax.Array   # bool
    carry: jax.Array         # int32 (CARRY_BITS,) frame-sync bit carry
    carry_len: jax.Array     # int32 (0 on the first block, then 27)
    base_pos: jax.Array      # int32 global position of this block's window 0
    last_position: jax.Array  # int32, -1 until first sync
    bad_count: jax.Array     # int32 consecutive false positives (resync)
    offset_frac: jax.Array   # float timing-loop integrator ('gardner' mode)
    derot_phase: jax.Array   # float carried constellation angle (derotate)


class FrameOutputs(NamedTuple):
    n_sym: jax.Array         # int32
    symbols_i: jax.Array     # (S_MAX,) float, padded
    symbols_q: jax.Array     # (S_MAX,) float (constellation diagnostics)
    n_windows: jax.Array     # int32
    syndrome_id: jax.Array   # (W_MAX,) int32: 0 none, 1..5 = A,B,C,D,C'
    is_sync: jax.Array       # (W_MAX,) bool: accepted (26-spaced) sync
    is_false_pos: jax.Array  # (W_MAX,) bool: matched but wrongly spaced
    positions: jax.Array     # (W_MAX,) int32 global bit positions
    is_resync: jax.Array     # (W_MAX,) bool: resync fired after this window
    info_word: jax.Array     # (W_MAX,) int32: the window's 16 info bits,
    #                          MSB-first (payload for group decoding — the
    #                          reference stops at syndromes,
    #                          src/fm_radio.cpp:649-696)
    corrected: jax.Array     # (W_MAX,) bool: syndrome repaired by burst
    #                          correction (error_correct=True); info_word
    #                          and syndrome_id already reflect the repair


def frame_init(cfg: ReceiverConfig, dtype=jnp.float32) -> FrameState:
    i32 = jnp.int32
    return FrameState(
        offset=jnp.zeros((), i32),
        start_pos=jnp.zeros((), i32),
        lonely_bit=jnp.zeros((), dtype),
        prebit=jnp.zeros((), i32),
        first_block=jnp.ones((), jnp.bool_),
        carry=jnp.zeros((CARRY_BITS,), i32),
        carry_len=jnp.zeros((), i32),
        base_pos=jnp.zeros((), i32),
        last_position=jnp.full((), -1, i32),
        bad_count=jnp.zeros((), i32),
        offset_frac=jnp.zeros((), dtype),
        derot_phase=jnp.zeros((), dtype),
    )


def frame_sizes(cfg: ReceiverConfig) -> tuple[int, int, int, int]:
    """(S_MAX symbols, B_MAX bits, E_MAX ext bits, W_MAX windows) per block."""
    r_len = cfg.rds_len
    s_max = r_len // cfg.rds.sps
    b_max = s_max // 2
    e_max = CARRY_BITS + b_max
    w_max = e_max - 26
    return s_max, b_max, e_max, w_max


def resolve_sync(sid, w_valid, base_pos, last_position, bad_count,
                 *, resync: bool, corr=None):
    """Resolve which syndrome matches are accepted 26-spaced syncs.

    Semantics identical to the reference's sequential walk
    (src/fm_radio.cpp:649-713): a match is accepted iff never-synced-before
    or exactly 26 bits after the last accepted sync; other matches are
    false positives.  With ``resync`` (the C++ recovery mechanism), >10
    consecutive false positives reset the anchor.

    ``corr`` (optional bool array): windows whose syndrome was REPAIRED by
    burst correction.  Corrected windows extend an existing 26-spaced
    chain (they are accepted only at on-chain positions, never as the
    anchor — a repaired match is too weak evidence to start a lattice
    on), never count as false positives, and never trip the resync
    counter.

    Without resync the recurrence has a closed form — no sequential scan:
    acceptances within a block form ONE arithmetic chain of 26-spaced
    positions.  Entering synced (last>=0) the chain can only start at
    w_chain = last+26-base (gp-last==26 has exactly one solution, and last
    does not move until it hits); entering unsynced it starts at the first
    match.  Position start+26k is accepted iff every chain position
    start..start+26k matched (one miss and last stops advancing, making
    every later gp-last != 26) — a cumulative-AND, i.e. cumsum of misses
    == 0.  Equivalence with the sequential walk is property-tested over
    random match patterns (tests/test_frame_edges.py).

    Returns (is_sync, is_false_pos, is_resync, new_last_position,
    new_bad_count); all per-window arrays are length ``len(sid)``.
    """
    i32 = jnp.int32
    w_max = sid.shape[-1]
    w = jnp.arange(w_max, dtype=i32)
    positions = base_pos + w
    if corr is None:
        corr = jnp.zeros((w_max,), jnp.bool_)

    if not resync:
        is_match = (sid > 0) & w_valid
        full = is_match | (corr & w_valid)
        synced = last_position >= 0
        w_chain = last_position + 26 - base_pos
        # the anchor (chain start when entering unsynced) must be an
        # EXACT match — corrected windows only continue a chain
        w_first = jnp.argmax(is_match).astype(i32)
        start = jnp.where(synced, w_chain, w_first)
        delta = w - start
        on_chain = (delta >= 0) & (delta % 26 == 0)
        # synced with the chain slot already behind this block: nothing
        # can be accepted (gp-last==26 unreachable; matches the walk).
        # Unsynced with no exact match: nothing can anchor (argmax's 0
        # must not let a corrected window at w=0 start a chain).
        possible = jnp.where(synced, w_chain >= 0, jnp.any(is_match))
        fails = on_chain & ~full
        cum_fails = jnp.cumsum(fails.astype(i32))
        is_sync = on_chain & full & (cum_fails == 0) & possible
        is_fp = is_match & ~is_sync
        is_resync = jnp.zeros((w_max,), jnp.bool_)
        any_acc = jnp.any(is_sync)
        w_last = jnp.max(jnp.where(is_sync, w, -1))
        new_last = jnp.where(any_acc, base_pos + w_last, last_position)
        return is_sync, is_fp, is_resync, new_last, bad_count

    def scan_fn(carry, inp):
        last_pos, bad = carry
        sid_w, gp, valid, corr_w = inp
        is_match = (sid_w > 0) & valid
        ok = (last_pos < 0) | (gp - last_pos == 26)
        real = (is_match & ok) | (corr_w & valid & (last_pos >= 0)
                                  & (gp - last_pos == 26))
        fp = is_match & ~ok
        last_pos = jnp.where(real, gp, last_pos)
        bad = jnp.where(real, 0, jnp.where(fp, bad + 1, bad))
        fire = bad > 10
        last_pos = jnp.where(fire, -1, last_pos)
        bad = jnp.where(fire, 0, bad)
        return (last_pos, bad), (real, fp, fire)

    ((new_last, new_bad), (is_sync, is_fp, is_resync)) = jax.lax.scan(
        scan_fn, (last_position, bad_count),
        (sid, positions, w_valid, corr), unroll=8)
    return is_sync, is_fp, is_resync, new_last, new_bad


def make_frame(cfg: ReceiverConfig, offset_mode: str = "hold",
               use_abs_clock: bool = False, resync: bool = False,
               with_cprime: bool = True, error_correct: bool = False,
               derotate: bool = False):
    """Returns ``frame(state, rrc_i, rrc_q) -> (outputs, new_state)``.

    Operates per channel (1-D inputs of length cfg.rds_len); ``jax.vmap``
    for multi-channel use.

    ``with_cprime`` (default True) also matches the C' offset word that
    real version-B groups (0B/2B/15B) transmit in block 3 (IEC 62106
    offset-word table).  The reference checks only A/B/C/D
    (src/fm_radio.cpp:479-482), so on a standards-compliant signal its
    sync chain breaks at every version-B group; pass False only for
    strict reference-parity comparisons.  syndrome_id 5 = C'.

    ``error_correct`` (off by default for reference/golden parity) enables
    the (26,16) code's burst correction (<=5-bit bursts, IEC 62106 annex
    B): a non-matching window whose error syndrome hits the burst table
    for exactly ONE offset word is repaired — its info bits are XOR-fixed
    and it extends an existing 26-spaced sync chain (never anchors one;
    see resolve_sync).  The ``corrected`` output column counts repairs.
    The reference detects errors only (src/fm_radio.cpp:631-646).

    ``resync=True`` adds the C++'s recovery mechanism (src/fm_radio.cpp:
    699-704): after >10 consecutive wrongly-spaced syndrome matches the
    sync anchor resets, letting the decoder re-acquire after a signal
    dropout.  Off by default for golden-model parity.

    ``offset_mode``: clock-recovery strategy.
      * 'hold'  — block-0 argmax held forever (the C++'s behavior,
                  src/fm_radio.cpp:529-538); default, golden parity.
      * 'track' — the model's per-block phase bookkeeping
                  (model/fmRDSblock.py:219); golden parity.  NOTE the
                  model's update maps phase k to 24-k (its own quirk),
                  so unless the acquired offset is 12 (or 0/24) the
                  sampling phase oscillates off-peak on alternate
                  blocks — keep it for model-parity checks, use
                  'hold'/'gardner' for real decoding.
      * 'argmax' — re-estimate the offset from each block's first symbol
                  period; self-corrects slow clock drift at the cost of
                  occasional one-symbol slips at re-estimation seams, and
                  jitters when the true offset sits near the wrap
                  boundary — prefer 'gardner' for sustained skew.
      * 'gardner' — decision-directed Gardner timing loop (beyond the
                  reference): per block, the timing error
                  mean(mid_n * (sym_n - sym_{n-1})) drives an integrator
                  that steps the offset by at most one sample per block —
                  tracks receiver sample-clock error (XO ppm) that defeats
                  both reference modes.

    ``derotate`` (off by default for golden parity): estimate the
    constellation rotation per block by the BPSK squaring method —
    theta = angle(sum (sym_i + j*sym_q)^2) / 2 over the block's symbols
    — and rotate the symbols back onto the I axis before slicing.  A
    detuned carrier shifts the recovered 57 kHz phase (the squared-BPF
    phase response at the offset frequency), rotating energy onto Q
    where the reference's I-only decisions lose margin; the round-5
    decode campaign measured the chain dead at +200 Hz pilot detune
    without this.  The estimate's pi ambiguity is harmless (differential
    decode is polarity-invariant); the carried angle keeps the branch
    choice continuous across blocks so polarity flips cannot happen
    mid-stream.
    """
    assert offset_mode in ("hold", "track", "argmax", "gardner")
    r_len = cfg.rds_len
    sps = cfg.rds.sps
    s_max, b_max, e_max, w_max = frame_sizes(cfg)
    h_mat = jnp.asarray(H_MATRIX)
    synds = jnp.asarray(SYNDROMES if with_cprime else SYNDROMES[:4])
    g_gain = gardner_gain(cfg) if offset_mode == "gardner" else 0.0

    def frame(state: FrameState, rrc_i: jax.Array, rrc_q: jax.Array):
        i32 = jnp.int32

        # ---- clock recovery (model/fmRDSblock.py:207-219) ----
        first24 = rrc_i[:sps]
        if offset_mode in ("argmax", "gardner"):
            # extension modes use the square-law timing metric over the
            # WHOLE block, folded mod sps: sum_m i^2+q^2 at each phase.
            # Rotation-invariant (a detuned carrier rotates the
            # constellation off the I axis, where the reference's
            # one-symbol rrc_i peek goes blind — found by the round-5
            # decode campaign at +200 Hz pilot detune) and averages
            # ~150 symbols instead of one.
            e_len = (rrc_i.shape[-1] // sps) * sps
            env = (rrc_i[:e_len] * rrc_i[:e_len]
                   + rrc_q[:e_len] * rrc_q[:e_len])
            peak = env.reshape(-1, sps).sum(axis=0)
        else:
            # golden-parity modes keep the model's one-symbol peek; the
            # signed form picks a wrong offset on any block whose first
            # symbol is negative, so use_abs_clock offers the magnitude
            peak = jnp.abs(first24) if use_abs_clock else first24
        offset0 = jnp.argmax(peak).astype(i32)
        carried_start = state.start_pos
        if offset_mode == "argmax":
            offset = offset0  # re-estimated every block
            # if the fresh estimate wrapped relative to the last block's,
            # one symbol was skipped/duplicated at the seam — this
            # block's Manchester pairing parity is flipped
            slipped_now = ((~state.first_block)
                           & (jnp.abs(offset - state.offset) > sps // 2))
            carried_start = jnp.where(slipped_now, 1 - carried_start,
                                      carried_start)
        else:
            offset = jnp.where(state.first_block, offset0, state.offset)

        # symbols = rrc[offset::24].  r_len = s_max*sps exactly, so the
        # reshape (s_max, sps) holds every phase; selecting the offset
        # column via a one-hot sum is gather-free (no vmapped per-channel
        # gather) and exact.  Track mode can produce
        # offset == sps (== phase 0 one symbol later): fold the dropped
        # first symbol in with a validity mask.
        phases_i = rrc_i.reshape(s_max, sps)
        phases_q = rrc_q.reshape(s_max, sps)
        onehot = (jnp.arange(sps, dtype=i32) == offset % sps).astype(rrc_i.dtype)
        sym_i = jnp.sum(phases_i * onehot, axis=-1)
        sym_q = jnp.sum(phases_q * onehot, axis=-1)
        n_sym = ((r_len - offset + sps - 1) // sps).astype(i32)
        # offset==sps: symbols start one sample-row later; shift left by one
        shift_sym = (offset >= sps).astype(i32)
        sym_i = jnp.where(shift_sym == 1, jnp.roll(sym_i, -1), sym_i)
        sym_q = jnp.where(shift_sym == 1, jnp.roll(sym_q, -1), sym_q)
        sym_pos_valid = jnp.arange(s_max, dtype=i32) < n_sym
        sym_i = jnp.where(sym_pos_valid, sym_i, 0.0)
        sym_q = jnp.where(sym_pos_valid, sym_q, 0.0)

        derot_new = state.derot_phase
        if derotate:
            # BPSK squaring estimate: sum of (i+jq)^2 over the block's
            # symbols points at 2*theta (the data sign squares away);
            # padding symbols are exact zeros and add nothing
            c2r = jnp.sum(sym_i * sym_i - sym_q * sym_q)
            c2i = jnp.sum(2.0 * sym_i * sym_q)
            th = 0.5 * jnp.arctan2(c2i, c2r)
            # continuity: of the pi-spaced candidates, keep the one
            # nearest the carried angle (polarity never flips mid-stream)
            pi_ = jnp.asarray(np.pi, sym_i.dtype)
            adj = state.derot_phase + jnp.mod(
                th - state.derot_phase + pi_ / 2, pi_) - pi_ / 2
            th_u = jnp.where(state.first_block, th, adj)
            derot_new = jnp.mod(th_u + pi_, 2 * pi_) - pi_
            c, s = jnp.cos(th_u), jnp.sin(th_u)
            sym_i, sym_q = sym_i * c + sym_q * s, sym_q * c - sym_i * s

        new_frac = state.offset_frac
        if offset_mode == "track":
            new_offset = (sps + r_len - offset - sps * n_sym).astype(i32)
        elif offset_mode == "gardner":
            # Gardner TED over the block: midpoints via a second one-hot
            # phase plane (gather-free), error normalized by symbol power,
            # integrator steps the offset at most +-1 sample per block
            half = sps // 2
            mid_off = jnp.mod(offset - half, sps)
            onehot_m = (jnp.arange(sps, dtype=i32)
                        == mid_off).astype(rrc_i.dtype)
            midm = jnp.sum(phases_i * onehot_m, axis=-1)
            if derotate:
                # keep the TED coherent with the derotated symbols (a
                # raw-I midpoint shrinks by cos(theta) and dies at 90)
                midq = jnp.sum(phases_q * onehot_m, axis=-1)
                midm = midm * c + midq * s
            # midm[j] sits between sym[j-1], sym[j] when offset >= half,
            # else between sym[j], sym[j+1] -> use previous row for pair n
            mid_n = jnp.where(offset >= half, midm,
                              jnp.concatenate([midm[:1], midm[:-1]]))
            dsym = sym_i - jnp.concatenate([sym_i[:1], sym_i[:-1]])
            nmask = (jnp.arange(s_max, dtype=i32) >= 1) & sym_pos_valid
            num = jnp.sum(jnp.where(nmask, dsym * mid_n, 0.0))
            den = jnp.sum(jnp.where(sym_pos_valid, sym_i * sym_i, 0.0))
            e = num / (den + jnp.asarray(1e-12, den.dtype))
            # e > 0 <=> sampling late (mid sample past the transition
            # crossing, same sign as the symbol step) -> move earlier
            frac = state.offset_frac - g_gain * e
            step = jnp.clip(jnp.round(frac), -1.0, 1.0)
            new_frac = frac - step
            new_offset = jnp.mod(offset + step.astype(i32), sps)
        else:
            new_offset = offset
        # an offset WRAP (gardner) skips or duplicates one symbol at the
        # next block seam, which flips the Manchester pairing parity —
        # carry the flipped phase (one group is corrupted at the slip,
        # ~every sps/|drift| blocks; without this the decoder never
        # re-pairs and dies after the first wrap).  Applied to start_pos
        # after the screening section computes it.
        gardner_slip = (jnp.abs(new_offset - offset) > sps // 2
                        if offset_mode == "gardner" else None)

        # ---- Manchester phase screening, first block only
        # (model/fmRDSblock.py:233-250) ----
        # All symbol indexing below is via the static even/odd planes —
        # start_pos only selects between two statically-sliced variants, so
        # there are NO data-dependent (vmapped per-channel) gathers.
        def same_sign(a, b):
            return ((a > 0) & (b > 0)) | ((a < 0) & (b < 0))

        # s_max may be odd (e.g. scaled-down test geometries): the last
        # symbol then never pairs within the block (it is the lonely-bit
        # carry), so the even/odd planes cover exactly 2*b_max symbols
        pairs2_i = sym_i[:2 * b_max].reshape(b_max, 2)
        even, odd = pairs2_i[:, 0], pairs2_i[:, 1]

        s4 = s_max // 4
        m = jnp.arange(s4, dtype=i32)
        m_mask = m < n_sym // 4
        a0 = even[:s4]           # sym[2m]
        a1 = odd[:s4]            # sym[2m+1]
        a2 = even[1:s4 + 1]      # sym[2m+2]  (2m+2 <= s_max/2 < s_max)
        c0 = same_sign(a0, a1) & m_mask
        c1 = (~same_sign(a0, a1)) & same_sign(a1, a2) & m_mask
        count0 = jnp.sum(c0.astype(i32))
        count1 = jnp.sum(c1.astype(i32))
        start0 = jnp.where(count0 > count1, 1, 0).astype(i32)
        start_pos = jnp.where(state.first_block, start0, carried_start)
        start_pos_carry = (start_pos if gardner_slip is None
                           else jnp.where(gardner_slip, 1 - start_pos,
                                          start_pos))

        # ---- symbol pairs -> bits (model/fmRDSblock.py:252-277) ----
        # start_pos=0: bit j = sym[2j]   > sym[2j+1]  =  even[j] > odd[j]
        # start_pos=1: bit j = sym[2j-1] > sym[2j]    =  odd[j-1] > even[j]
        #              (j=0 handled by the carried front bit)
        j = jnp.arange(b_max, dtype=i32)
        odd_prev = jnp.concatenate([odd[:1], odd[:-1]])
        bits0 = (even > odd).astype(i32)
        bits1 = (odd_prev > even).astype(i32)
        pair_bits = jnp.where(start_pos == 0, bits0, bits1)
        front = ((state.lonely_bit > sym_i[0]) & ~state.first_block).astype(i32)
        bits = jnp.where((j == 0) & (start_pos == 1), front, pair_bits)
        n_bits = (n_sym // 2).astype(i32)
        # sym_i[n_sym-1] as a one-hot contraction (exact: others are *0)
        sym_last = jnp.sum(
            sym_i * (jnp.arange(s_max, dtype=i32) == n_sym - 1))
        lonely = jnp.where(start_pos == 1, sym_last, state.lonely_bit)

        # ---- differential decode (model/fmRDSblock.py:281-292) ----
        prev = jnp.concatenate([state.prebit[None], bits[:-1]])
        diff_all = jnp.bitwise_xor(bits, prev)
        shift = jnp.where(state.first_block, 1, 0).astype(i32)
        diff = jnp.where(shift == 1,
                         jnp.concatenate([diff_all[1:], diff_all[:1]]),
                         diff_all)
        n_diff = n_bits - shift
        prebit_new = jnp.sum(jnp.where(j == n_bits - 1, bits, 0))

        # ---- frame sync (model/fmRDSblock.py:296-346) ----
        # ext = [carry (carry_len) | diff (n_diff)], fixed size e_max; padded
        # bits past the valid length are ignored by the w < n_windows mask.
        # carry_len is only ever 0 (first block) or 27, so both layouts are
        # static concats and a select — no dynamic scatter.
        ext_first = jnp.concatenate([diff, jnp.zeros((CARRY_BITS,), i32)])
        ext_later = jnp.concatenate([state.carry, diff])
        ext = jnp.where(state.first_block, ext_first, ext_later)

        length = state.carry_len + n_diff
        n_windows = length - 26

        w = jnp.arange(w_max, dtype=i32)
        # windows[w, j] = ext[w + j]: 27 static shifted slices, no gather.
        # Column 26 (= ext[w + 26]) is not part of the 26-bit syndrome
        # window; it rides along so the 27-bit carry below is one one-hot
        # row-select of this matrix instead of a vmapped dynamic_slice
        # (which lowers to a per-channel gather).
        windows27 = jnp.stack(
            [jax.lax.slice_in_dim(ext, j, j + w_max, axis=0)
             for j in range(CARRY_BITS)], axis=1)
        windows = windows27[:, :26]
        # GF(2) syndrome: one matmul over every window at once, in float32
        # at full precision (sums are <= 26, exact).  Every dot of this
        # layer asks for PRECISION: a TF32 operand cannot hold the 16-bit
        # info and error words below.
        synd = jnp.mod(
            jax.lax.dot_general(
                windows.astype(jnp.float32), h_mat.astype(jnp.float32),
                dimension_numbers=(((1,), (0,)), ((), ())),
                precision=PRECISION, preferred_element_type=jnp.float32),
            2.0).astype(i32)
        match = jnp.all(synd[:, None, :] == synds[None, :, :], axis=-1)
        sid = jnp.where(jnp.any(match, axis=-1),
                        jnp.argmax(match, axis=-1).astype(i32) + 1, 0)

        # 16-bit info payload per window.  The RDS standard transmits
        # [info(16, MSB first) | crc^offset(10)]; that layout yields exactly
        # the reference's syndrome values under H (verified against the
        # standard generator polynomial in test_frame_edges.py), so on a
        # real capture the info word is window bits 0..15.  One exact
        # float32 matvec, no gathers.
        pow2 = jnp.asarray(2.0 ** np.arange(15, -1, -1), jnp.float32)
        info_word = jnp.matmul(windows27[:, :16].astype(jnp.float32), pow2,
                               precision=PRECISION).astype(i32)

        if error_correct:
            # burst correction: error syndrome = syndrome XOR offset-word
            # syndrome; a hit in the (collision-free) burst table repairs
            # the block.  All arithmetic rides the same exact-float32
            # dots as the syndrome matmul: the 1024-entry lookup is a
            # one-hot contraction, not a (vmapped per-channel) gather.
            pow2s = jnp.asarray(2.0 ** np.arange(9, -1, -1), jnp.float32)
            synd_int = jnp.matmul(synd.astype(jnp.float32), pow2s,
                                  precision=PRECISION).astype(i32)
            offs_np = np.asarray(
                SYNDROMES if with_cprime else SYNDROMES[:4])
            off_int = jnp.asarray(
                (offs_np @ (1 << np.arange(9, -1, -1))).astype(np.int32))
            e_syn = jnp.bitwise_xor(synd_int[:, None], off_int[None, :])
            flag_np, errinfo_np, errspan_np = _burst_table()
            eq = (e_syn[..., None]
                  == jnp.arange(1024, dtype=i32)).astype(jnp.float32)
            def lookup(table):                                  # (W, O)
                return jnp.matmul(eq, jnp.asarray(table, jnp.float32),
                                  precision=PRECISION)

            corr_ok = lookup(flag_np)
            err_info = lookup(errinfo_np)
            err_span = lookup(errspan_np)
            # several offset words usually "explain" a corrupted block
            # (chance table hits); the SHORTEST burst is the credible
            # repair — accept it only when it is strictly shortest
            # (ties reject) and the window didn't already match exactly
            cost = jnp.where(corr_ok > 0, err_span, jnp.inf)
            best = jnp.min(cost, axis=-1)
            n_best = jnp.sum((cost == best[:, None]).astype(i32), axis=-1)
            corr = jnp.isfinite(best) & (n_best == 1) & (sid == 0)
            o_sel = jnp.argmin(cost, axis=-1).astype(i32)
            sel_hot = (jnp.arange(off_int.shape[0], dtype=i32)[None, :]
                       == o_sel[:, None]).astype(jnp.float32)
            err_sel = jnp.sum(err_info * sel_hot, axis=-1).astype(i32)
            info_word = jnp.where(
                corr, jnp.bitwise_xor(info_word, err_sel), info_word)
        else:
            corr = jnp.zeros((w_max,), jnp.bool_)

        positions = state.base_pos + w
        w_valid = w < n_windows

        # resolve sees exact matches (sid) and repairs (corr) separately:
        # repairs may only CONTINUE a chain; the merged id is for output
        (is_sync, is_fp, is_resync, last_position, bad_count) = resolve_sync(
            sid, w_valid, state.base_pos, state.last_position,
            state.bad_count, resync=resync, corr=corr)
        if error_correct:
            sid = jnp.where(corr, o_sel + 1, sid)

        # carry = ext[n_windows-1 : n_windows-1+27] — a one-hot row-select
        # of windows27 (gather-free; the float32 dot is exact for 0/1 data)
        row_hot = (w == n_windows - 1).astype(jnp.float32)
        carry_new = jnp.einsum(
            "w,wj->j", row_hot, windows27.astype(jnp.float32),
            precision=PRECISION).astype(i32)
        base_new = state.base_pos + n_windows - 1

        outputs = FrameOutputs(
            n_sym=n_sym, symbols_i=sym_i, symbols_q=sym_q,
            n_windows=n_windows, syndrome_id=sid, is_sync=is_sync,
            is_false_pos=is_fp, positions=positions, is_resync=is_resync,
            info_word=info_word, corrected=corr & is_sync)
        new_state = FrameState(
            offset=new_offset, start_pos=start_pos_carry, lonely_bit=lonely,
            prebit=prebit_new, first_block=jnp.zeros((), jnp.bool_),
            carry=carry_new, carry_len=jnp.full((), CARRY_BITS, i32),
            base_pos=base_new, last_position=last_position,
            bad_count=bad_count, offset_frac=new_frac,
            derot_phase=derot_new)
        return outputs, new_state

    return frame
