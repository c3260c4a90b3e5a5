"""SIG-driven dynamic receive (port of jrc_tpu/ops/dynamic_rx.py).

MCS, length and packet type are learned per frame from the SIG field. As
in the reference, symbols are extracted up to the ``max_payload`` envelope
and masked by the SIG-derived symbol count, and ONE Viterbi pass serves
every MCS and length: each frame's values are padded with erasures to the
shared ``2·max_trellis_bits`` envelope, and each row of the pass runs to its
own extent, the ``n_data_bits`` its SIG field gives (``viterbi_cuda``: the
bits of the whole envelope, in the time of the longest row).

Batched over frames (B, ...) where the reference vmapped one frame. The
reference's ``lax.switch`` over the six MCS branches computes all six for
every frame under ``vmap`` and selects one per frame; so does
``payload_values_dynamic``: each MCS's demap and depuncture run over the
whole batch and each frame takes its own MCS's row, with no host sync, so a
call can be captured as one CUDA graph.

``estimator="sta"`` is the reference's masked decision-directed scan: a loop
over the envelope's symbols in order, each step on the whole frame batch,
the hard re-modulation taken under each frame's SIG MCS (all three
constellations decided, one selected per frame). ``soft=True`` feeds
max-log-MAP LLRs to the shared Viterbi pass instead of ±1.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from jrc_tpu_torch.config import MCS, MCSParams, OFDMConfig
from jrc_tpu_torch.ops import coding, equalizer, ofdm, sync, viterbi_cuda
from jrc_tpu_torch.ops.modulation import hard_decision, modulate, soft_llr
from jrc_tpu_torch.ops.viterbi import hard_to_values
from jrc_tpu_torch.tables import DynTables
from jrc_tpu_torch.utils.profiling import stamp


def max_symbols(max_payload: int, n_data_carriers: int = 48) -> int:
    """Worst-case DATA symbol count over all MCS (BPSK-1/2 ⇒ n_dbps=24)."""
    return math.ceil((16 + 8 * (max_payload + 4) + 6) / (n_data_carriers // 2))


def max_trellis_bits(max_payload: int, n_data_carriers: int = 48) -> int:
    """Static trellis length covering every MCS branch's envelope (the
    per-branch symbol capacity rounds up differently per n_dbps)."""
    return max(_branch_max_bits(m, max_payload, n_data_carriers) for m in MCS)


def _branch_max_sym(mcs: MCS, max_payload: int, n_data_carriers: int) -> int:
    return math.ceil((16 + 8 * (max_payload + 4) + 6) / MCSParams(mcs, n_data_carriers).n_dbps)


def _branch_max_bits(mcs: MCS, max_payload: int, n_data_carriers: int) -> int:
    return (_branch_max_sym(mcs, max_payload, n_data_carriers)
            * MCSParams(mcs, n_data_carriers).n_dbps)


def frame_geometry(tab: DynTables, mcs_idx: torch.Tensor, data_size_byte: torch.Tensor):
    """Per-frame packet math (reference lib/utils.cc:26-53): (n_ofdm_sym,
    n_data_bits) from MCS indices and byte counts (payload + 4 CRC)."""
    dbps = tab.n_dbps[mcs_idx]
    n_sym = (16 + 8 * data_size_byte.to(torch.int64) + 6 + dbps - 1) // dbps
    return n_sym, n_sym * dbps


class DynamicFrame(NamedTuple):
    payload: torch.Tensor  # (B, max_payload) uint8, valid up to payload_len
    payload_len: torch.Tensor  # (B,) bytes (without CRC)
    crc_ok: torch.Tensor  # (B,) bool
    mcs: torch.Tensor  # (B,) int64 MCS index
    packet_type_bit: torch.Tensor  # (B,) 0 = NDP, 1 = DATA
    n_ofdm_sym: torch.Tensor  # (B,)
    sig_ok: torch.Tensor  # (B,) bool
    snr_db: torch.Tensor  # (B,) legacy-LTF estimate
    snr_data_db: torch.Tensor  # (B,) pilot-tracked payload SNR
    chan_est: torch.Tensor  # (B, fft_len, n_tx) complex64 NDP MIMO estimate
    chan_est_ok: torch.Tensor  # (B,) NDP frame with valid SIG → chan_est is live


class DynamicPre(NamedTuple):
    """Pre-Viterbi state of a batch of dynamic frames (lets the caller run
    ONE Viterbi over all of them)."""

    values: torch.Tensor  # (B, 2·max_trellis_bits) depunctured channel values
    mcs: torch.Tensor
    length: torch.Tensor  # data_size_byte from SIG (payload + 4 CRC)
    packet_type_bit: torch.Tensor
    n_ofdm_sym: torch.Tensor
    n_data_bits: torch.Tensor  # the trellis steps of the values; erasures after them
    sig_ok: torch.Tensor
    snr_db: torch.Tensor
    snr_data_db: torch.Tensor
    chan_est: torch.Tensor


def _demap(tab: DynTables, z: torch.Tensor, n_bpsc: int, soft: bool) -> torch.Tensor:
    """(B, n_sym, n_dc) symbols → (B, n_sym·n_dc·n_bpsc) channel values under
    the constellation of ``n_bpsc`` bits: LLRs with ``soft``, else ±1."""
    zz = z.reshape(z.shape[0], -1)
    if soft:
        return soft_llr(zz, tab.points(n_bpsc), n_bpsc)
    return hard_to_values(coding.merge_symbols(hard_decision(zz, tab.points(n_bpsc)), n_bpsc))


def _branch_values(tab: DynTables, mcs: MCS, chan: torch.Tensor, n_bytes: torch.Tensor,
                   max_payload: int, t_max: int, n_dc: int) -> torch.Tensor:
    """One MCS branch over a batch of frames: depuncture the demapped
    ``chan`` (at least the branch's symbols), erase past each frame's coded
    extent, pad with erasures to 2·t_max."""
    mp = MCSParams(mcs, n_dc)
    branch_max_sym = _branch_max_sym(mcs, max_payload, n_dc)
    branch_max_bits = branch_max_sym * mp.n_dbps
    _, n_data_bits = frame_geometry(tab, torch.full_like(n_bytes, int(mcs)), n_bytes)
    values = coding.depuncture(chan[:, : branch_max_sym * mp.n_cbps], mcs, 2 * branch_max_bits,
                               erasure=0.0)
    pos = torch.arange(2 * branch_max_bits, device=chan.device)
    values = torch.where(pos < 2 * n_data_bits[:, None], values, 0.0)
    return F.pad(values, (0, 2 * t_max - 2 * branch_max_bits))


def payload_values_dynamic(
    tab: DynTables,
    z: torch.Tensor,  # (B, max_n_sym, n_dc) equalized symbols, zero past each frame
    mcs_idx: torch.Tensor,  # (B,)
    data_size_byte: torch.Tensor,  # (B,)
    max_payload: int,
    soft: bool = False,
) -> torch.Tensor:
    """Demap → depuncture under each frame's own MCS → (B, 2·t_max) values
    with erasures past each frame's true coded extent, as the reference's
    per-frame ``lax.switch`` under ``vmap``: every MCS branch runs over the
    whole batch and each frame takes the row of its clamped ``mcs_idx`` (no
    host sync). The demap is elementwise, so each constellation is demapped
    once, over the symbols of its longest branch (rate 1/2), and its rate-3/4
    branch reads a prefix. ``soft`` feeds LLRs instead of ±1."""
    n_dc = z.shape[-1]
    t_max = max_trellis_bits(max_payload, n_dc)
    mcs_idx = mcs_idx.clamp(0, len(MCS) - 1)
    chan, values = {}, None
    for mcs in MCS:
        n_bpsc = MCSParams(mcs, n_dc).n_bpsc
        if n_bpsc not in chan:  # the one constellation's values kept at a time
            n_sym = max(_branch_max_sym(m, max_payload, n_dc) for m in MCS
                        if MCSParams(m, n_dc).n_bpsc == n_bpsc)
            chan = {n_bpsc: _demap(tab, z[:, :n_sym], n_bpsc, soft)}
        branch = _branch_values(tab, mcs, chan[n_bpsc], data_size_byte, max_payload, t_max, n_dc)
        values = (branch if values is None
                  else torch.where((mcs_idx == int(mcs))[:, None], branch, values))
    return values


def decode_payload_dynamic(
    cfg: OFDMConfig,
    tab: DynTables,
    z: torch.Tensor,  # (B, max_n_sym, 48) equalized symbols, zero past each frame
    mcs_idx: torch.Tensor,
    data_size_byte: torch.Tensor,
    max_payload: int,
):
    """Demap under each frame's MCS → ONE Viterbi pass (K1) over the batch,
    each row to its own coded extent → descramble → CRC: (payload bytes (B,
    max_payload+4), crc_ok (B,))."""
    values = payload_values_dynamic(tab, z, mcs_idx, data_size_byte, max_payload)
    _, n_data_bits = frame_geometry(tab, mcs_idx.clamp(0, len(MCS) - 1), data_size_byte)
    decoded = viterbi_cuda.viterbi_decode(values, tab.trellis, n_out=16 + 8 * (max_payload + 4),
                                          n_steps=n_data_bits)
    return payload_from_bits_dynamic(tab, decoded, data_size_byte, max_payload)


def payload_from_bits_dynamic(tab: DynTables, decoded: torch.Tensor,
                              data_size_byte: torch.Tensor, max_payload: int):
    """(B, ≥ 16 + 8·(max_payload+4)) Viterbi output → (pdu (B, max_payload+4)
    uint8, crc_ok): descramble → bytes → CRC over each frame's own length."""
    max_bytes = max_payload + 4
    descrambled = coding.descramble(decoded, tab.descramble_basis)
    pdu = coding.bits_to_bytes(descrambled[..., 16 : 16 + 8 * max_bytes])
    crc_ok = coding.crc32_check_residue(pdu, tab.crc_T, tab.crc_E, n_valid=data_size_byte)
    return pdu, crc_ok


def equalize_data_masked(cfg: OFDMConfig, tab: DynTables, y_data: torch.Tensor,
                         h_legacy: torch.Tensor, h_eff: torch.Tensor,
                         is_data: torch.Tensor, n_sym: torch.Tensor):
    """Payload equalization over the max envelope, masked by each frame's
    SIG symbol count: per-symbol CPE, the running pilot-noise estimate over
    active symbols only, MMSE on ``h_eff`` for DATA frames and ZF on
    ``h_legacy`` for NDP frames, zero past ``n_sym``. y_data (B, max_n_sym,
    fft_len) → (z (B, max_n_sym, 48), snr_data_dB (B,))."""
    n = y_data.shape[1]
    dev = y_data.device
    d, p = tab.data_idx, tab.pilot_idx
    ks = torch.arange(n, device=dev)
    active = ks[None, :] < n_sym[:, None]  # (B, n)
    w = active.to(torch.float32)
    h0 = torch.where(is_data[:, None], h_eff, h_legacy)
    refs = tab.pilot_symbols[ks % tab.pilot_symbols.shape[0]]  # (n, n_pilot)
    beta, est = equalizer.common_phase_error(tab, y_data, h0[:, None, :], refs[None])
    y_rot = y_data * sync.expj(-beta)[..., None]
    sig_k = equalizer.abs2(est).sum(-1)  # (B, n)
    noise_k = equalizer.abs2(est - y_rot[..., p]).sum(-1)
    noise_cum = torch.cumsum(w * noise_k, dim=-1)
    count_cum = torch.cumsum(torch.where(active, cfg.n_pilot_carriers, 0), dim=-1)
    hd = h0[:, None, d]
    csi = equalizer.abs2(hd) + (noise_cum / count_cum.clamp_min(1))[..., None]
    z_mmse = y_rot[..., d] * hd.conj() / csi
    z_zf = y_rot[..., d] / hd
    z = torch.where(is_data[:, None, None], z_mmse, z_zf)
    z = torch.where(active[..., None], z, 0)
    sig_sum = (w * sig_k).sum(-1)
    noise_sum = noise_cum[:, -1]
    snr_data = 10.0 * torch.log10(sig_sum.clamp_min(1e-30) / noise_sum.clamp_min(1e-30))
    return z, snr_data


def equalize_data_masked_sta(cfg: OFDMConfig, tab: DynTables, y_data: torch.Tensor,
                             h_legacy: torch.Tensor, h_eff: torch.Tensor,
                             is_data: torch.Tensor, n_sym: torch.Tensor, mcs_idx: torch.Tensor):
    """``equalize_data_masked`` with STA tracking: per symbol, CPE and
    MMSE / ZF on the tracked channel, then the channel of every frame still
    inside its ``n_sym`` moved toward y / x̂ (data carriers, x̂ decided and
    re-modulated under the frame's SIG MCS) and y / pilot (pilot carriers),
    α = 0.4 for DATA and 0.5 for NDP frames."""
    n = y_data.shape[1]
    d, p = tab.data_idx, tab.pilot_idx
    alpha = torch.where(is_data, equalizer.STA_ALPHA_DATA, equalizer.STA_ALPHA_NDP)
    alpha = alpha.to(torch.float32)[:, None]
    n_bpsc = tab.n_bpsc[mcs_idx.clamp(0, len(MCS) - 1)][:, None]
    h = torch.where(is_data[:, None], h_eff, h_legacy)
    sig_sum = torch.zeros(y_data.shape[0], dtype=torch.float32, device=y_data.device)
    noise_sum = torch.zeros_like(sig_sum)
    count = torch.zeros_like(n_sym)
    zs = []
    for k in range(n):
        active = k < n_sym  # (B,)
        w = active.to(torch.float32)
        ref = tab.pilot_symbols[k % tab.pilot_symbols.shape[0]]
        beta, est = equalizer.common_phase_error(tab, y_data[:, k], h, ref)
        y = y_data[:, k] * sync.expj(-beta)[:, None]
        sig_sum = sig_sum + w * equalizer.abs2(est).sum(-1)
        noise_sum = noise_sum + w * equalizer.abs2(est - y[:, p]).sum(-1)
        count = count + torch.where(active, cfg.n_pilot_carriers, 0)
        hd = h[:, d]
        csi = equalizer.abs2(hd) + (noise_sum / count.clamp_min(1))[:, None]
        z = torch.where(is_data[:, None], y[:, d] * hd.conj() / csi, equalizer.cdiv(y[:, d], hd))
        x_hat = None
        for nb in (4, 2, 1):
            pts = tab.points(nb)
            cand = modulate(hard_decision(z, pts), pts, nb)
            x_hat = cand if x_hat is None else torch.where(n_bpsc == nb, cand, x_hat)
        h_new = h.clone()
        h_new[:, d] = hd * (1 - alpha) + equalizer.cdiv(y[:, d], x_hat) * alpha
        h_new[:, p] = h[:, p] * (1 - alpha) + equalizer.cdiv(y[:, p], ref) * alpha
        h = torch.where(active[:, None], h_new, h)
        zs.append(torch.where(active[:, None], z, 0))
    snr_data = 10.0 * torch.log10(sig_sum.clamp_min(1e-30) / noise_sum.clamp_min(1e-30))
    return torch.stack(zs, dim=1), snr_data


def rx_frame_dynamic_values(
    cfg: OFDMConfig,
    tab: DynTables,
    x: torch.Tensor,  # flat sample stream (a trigger + the max window must fit)
    triggers: torch.Tensor,  # (B,)
    coarse_cfo: torch.Tensor,  # (B,)
    *,
    max_payload: int = 256,
    estimator: str = "ls",
    soft: bool = False,
    dq: float | None = None,  # the scale of an int16 (n, 2) stream
    entry: str | None = None,
) -> DynamicPre:
    """Sync (K3 twice over the max envelope) + SIG decode + equalize + demap
    of a batch of frames with SIG-discovered parameters, stopping before the
    Viterbi pass. With ``entry``, each step stamps that entry point's stage
    clock as it ends (``utils.profiling.stamp``): ``extract``, then
    ``equalize`` and ``demap``."""
    n_sym_total = 2 + 1 + cfg.n_ltf + max_symbols(max_payload, cfg.n_data_carriers)
    syms_t, total_cfo, _found = sync.extract_frames_batch(cfg, x, triggers, coarse_cfo,
                                                          n_sym_total, dq=dq)
    _stamp(entry, "extract", syms_t)
    return rx_frame_dynamic_values_from_syms(cfg, tab, syms_t, total_cfo, max_payload=max_payload,
                                             estimator=estimator, soft=soft, entry=entry)


def _stamp(entry: str | None, stage: str, like: torch.Tensor) -> None:
    if entry is not None:
        stamp(entry, stage, like)


def rx_frame_dynamic_values_from_syms(
    cfg: OFDMConfig,
    tab: DynTables,
    syms_t: torch.Tensor,  # (B, n_sym_total, fft_len) time-domain symbols
    total_cfo: torch.Tensor,  # (B,)
    *,
    max_payload: int = 256,
    estimator: str = "ls",
    soft: bool = False,
    entry: str | None = None,
) -> DynamicPre:
    """SIG decode + equalize + demap of already-extracted frames, stopping
    before the Viterbi pass; with ``entry``, stamps ``equalize`` and
    ``demap`` of its stage clock as those steps end."""
    sta = equalizer.check_estimator(estimator)
    grid, h_legacy, snr_db, (rate_bitmap, ptype, length, sig_ok) = equalizer.legacy_and_sig(
        cfg, tab, ofdm.fft_symbols(cfg, syms_t), total_cfo)
    rate = rate_bitmap.clamp(0, 15).to(torch.int64)
    mcs_idx = tab.rate_lut[rate]
    sig_ok = sig_ok & tab.rate_valid[rate]
    length = length.to(torch.int64).clamp(4, max_payload + 4)
    n_sym, n_data_bits = frame_geometry(tab, mcs_idx, length)

    # MIMO-LTF: both estimates, selected per frame by the packet type
    y_ltf = grid[:, 3 : 3 + cfg.n_ltf]
    h_eff = equalizer.effective_channel_estimate(cfg, tab, y_ltf)
    h_ndp, _ = equalizer.mimo_channel_estimate_ndp(tab, y_ltf)
    if sta:
        z, snr_data = equalize_data_masked_sta(cfg, tab, grid[:, 3 + cfg.n_ltf :], h_legacy,
                                               h_eff, ptype == 1, n_sym, mcs_idx)
    else:
        z, snr_data = equalize_data_masked(cfg, tab, grid[:, 3 + cfg.n_ltf :], h_legacy, h_eff,
                                           ptype == 1, n_sym)
    _stamp(entry, "equalize", z)
    values = payload_values_dynamic(tab, z, mcs_idx, length, max_payload, soft=soft)
    _stamp(entry, "demap", values)
    return DynamicPre(values=values, mcs=mcs_idx, length=length, packet_type_bit=ptype,
                      n_ofdm_sym=n_sym, n_data_bits=n_data_bits, sig_ok=sig_ok, snr_db=snr_db,
                      snr_data_db=snr_data, chan_est=h_ndp)


def rx_frame_dynamic_finish(tab: DynTables, pre: DynamicPre, decoded: torch.Tensor,
                            max_payload: int) -> DynamicFrame:
    """Viterbi output bits → DynamicFrame (descramble / bytes / CRC)."""
    pdu, crc_ok = payload_from_bits_dynamic(tab, decoded, pre.length, max_payload)
    return DynamicFrame(
        payload=pdu[..., :max_payload],
        payload_len=pre.length - 4,
        crc_ok=crc_ok & pre.sig_ok,
        mcs=pre.mcs,
        packet_type_bit=pre.packet_type_bit,
        n_ofdm_sym=pre.n_ofdm_sym,
        sig_ok=pre.sig_ok,
        snr_db=pre.snr_db,
        snr_data_db=pre.snr_data_db,
        chan_est=pre.chan_est,
        # the reference gates the NDP estimate on type + SIG only, before
        # any payload CRC
        chan_est_ok=(pre.packet_type_bit == 0) & pre.sig_ok,
    )


def rx_frame_dynamic(
    cfg: OFDMConfig,
    tab: DynTables,
    x: torch.Tensor,
    triggers: torch.Tensor,  # (B,)
    coarse_cfo: torch.Tensor,  # (B,)
    *,
    max_payload: int = 256,
    estimator: str = "ls",
    soft: bool = False,
    dq: float | None = None,
    entry: str | None = None,
) -> DynamicFrame:
    """Sync + equalize + decode a batch of frames with SIG-discovered
    parameters: K3 twice, ONE K1 over the batch whose rows each run to their
    own SIG extent, no host sync. With ``entry``, each step stamps that entry
    point's stage clock as it ends (``extract``, ``equalize``, ``demap``,
    ``viterbi``) and K1 writes its ``viterbi_steps`` count."""
    pre = rx_frame_dynamic_values(cfg, tab, x, triggers, coarse_cfo, max_payload=max_payload,
                                  estimator=estimator, soft=soft, dq=dq, entry=entry)
    decoded = viterbi_cuda.viterbi_decode(pre.values, tab.trellis,
                                          n_out=16 + 8 * (max_payload + 4),
                                          n_steps=pre.n_data_bits, entry=entry)
    _stamp(entry, "viterbi", decoded)
    return rx_frame_dynamic_finish(tab, pre, decoded, max_payload)
