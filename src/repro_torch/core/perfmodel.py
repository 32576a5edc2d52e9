"""Analytic GPU bottleneck model reproducing the paper's evaluation
(Figs 3, 10-15). Port of ``repro/core/perfmodel.py``, with its calibration
constants unchanged.

Its times are those of the paper's modelled GTX480 (GPGPU-Sim), not of any
card the port runs on: the model has no input from a device. It models the
same first-order effects the simulator exposes:

  T_layer = max( T_compute,               macs / C_eff
                 T_memory,                bytes_mem / BW_gddr_eff
                 T_aes,                   bytes_enc / BW_aes_total
                 (T_memory + T_aes)/phi ) pipeline-congestion term

with
  * bytes_mem: effective DRAM traffic. Conv/FC/GEMM layers are modeled with
    a tile-reuse bound: bytes_eff = max(min_bytes, macs / AI_eff) — cuDNN
    era Fermi kernels sustain ~5.4 MAC/B (calibration constant; the raw
    GEMM benchmark of paper §2.4 uses 4.0). Pool layers stream (min bytes).
  * Counter mode: each counter-cache miss adds one 128 B counter access
    (Tm) and a serialization penalty on the decrypt path
    (Ta *= 1 + lam*(1-hit)) — reproduces Fig 3a's ordering of Ctr-24..1536.
  * ColoE: +2/32 words inline counter traffic on encrypted lines, no extra
    accesses, no counter cache.

Calibration constants (C_eff, BW_gddr_eff, phi, lam) are fixed once, then
every paper claim is checked against this one model in
tests/test_perfmodel.py (and, for this port, tests/test_torch_perfmodel.py)
— no per-figure re-tuning.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.config import CNNConfig
from repro_torch.configs.vgg16 import config as vggc
from repro_torch.models.cnn import layer_traffic

# ---- calibration (single global set) -------------------------------------
C_EFF = 400e9          # effective MAC/s (GTX480 ~1.34 TFLOP/s fp32 peak)
BW_GDDR_EFF = 96e9     # achieved GDDR5 bandwidth (~54% of 177 GB/s peak)
BW_AES_TOTAL = 48e9    # 6 engines x 8 GB/s (paper Table 1/2)
AI_CONV = 5.4          # MAC/B sustained by conv-as-GEMM kernels
AI_GEMM = 3.6          # MAC/B of the raw GEMM benchmark (paper §2.4)
PHI = 1.65             # memory/AES pipeline overlap factor
LAM = 0.10             # counter-miss serialization on the decrypt path
CTR_HIT = {24: 0.55, 96: 0.67, 384: 0.78, 1536: 0.98}   # paper Fig 3b
LINE = 128             # bytes per memory line

SCHEMES = ("baseline", "direct", "counter", "direct+se", "counter+se", "seal")


@dataclasses.dataclass
class LayerWork:
    kind: str            # conv | pool | fc | gemm
    macs: float
    w_bytes: float
    in_bytes: float
    out_bytes: float
    enc_frac_w: float = 1.0
    enc_frac_in: float = 1.0
    enc_frac_out: float = 1.0

    @property
    def min_bytes(self) -> float:
        return self.w_bytes + self.in_bytes + self.out_bytes

    def bytes_eff(self) -> float:
        if self.kind == "pool":
            return self.min_bytes
        ai = AI_GEMM if self.kind == "gemm" else AI_CONV
        return max(self.min_bytes, self.macs / ai)

    def enc_frac(self) -> float:
        if self.min_bytes == 0:
            return 0.0
        e = (self.enc_frac_w * self.w_bytes + self.enc_frac_in * self.in_bytes
             + self.enc_frac_out * self.out_bytes)
        return e / self.min_bytes


@dataclasses.dataclass
class LayerTimes:
    t_compute: float
    t_memory: float
    t_aes: float
    total: float
    accesses_plain: float
    accesses_enc: float
    accesses_ctr: float


def evaluate_layer(w: LayerWork, scheme: str, ratio_applied: bool = True,
                   ctr_cache_kb: int = 96) -> LayerTimes:
    assert scheme in SCHEMES, scheme
    bytes_eff = w.bytes_eff()
    enc_frac = 0.0
    if scheme != "baseline":
        enc_frac = w.enc_frac() if scheme.endswith("se") or scheme == "seal" else 1.0
    bytes_enc = bytes_eff * enc_frac
    bytes_mem = bytes_eff
    acc_ctr = 0.0
    t_aes = bytes_enc / BW_AES_TOTAL
    if scheme in ("counter", "counter+se"):
        hit = CTR_HIT.get(ctr_cache_kb, 0.67)
        extra = (1.0 - hit) * bytes_enc          # one 128B counter line / miss
        bytes_mem += extra
        acc_ctr = extra / LINE
        t_aes *= (1.0 + LAM * (1.0 - hit))
    elif scheme == "seal":
        bytes_mem += bytes_enc * (2.0 / 32.0)    # inline counter words
    t_mem = bytes_mem / BW_GDDR_EFF
    t_comp = w.macs / C_EFF
    total = max(t_comp, t_mem, t_aes, (t_mem + t_aes) / PHI)
    return LayerTimes(t_comp, t_mem, t_aes, total,
                      accesses_plain=(bytes_eff - bytes_enc) / LINE,
                      accesses_enc=bytes_enc / LINE,
                      accesses_ctr=acc_ctr)


def evaluate_network(layers: List[LayerWork], scheme: str,
                     ctr_cache_kb: int = 96) -> Dict[str, float]:
    ts = [evaluate_layer(l, scheme, ctr_cache_kb=ctr_cache_kb) for l in layers]
    t_total = sum(t.total for t in ts)
    return {
        "time": t_total,
        "accesses_plain": sum(t.accesses_plain for t in ts),
        "accesses_enc": sum(t.accesses_enc for t in ts),
        "accesses_ctr": sum(t.accesses_ctr for t in ts),
    }


def relative_ipc(layers: List[LayerWork], scheme: str, **kw) -> float:
    base = evaluate_network(layers, "baseline", **kw)["time"]
    t = evaluate_network(layers, scheme, **kw)["time"]
    return base / t


def relative_latency(layers: List[LayerWork], scheme: str, **kw) -> float:
    base = evaluate_network(layers, "baseline", **kw)["time"]
    t = evaluate_network(layers, scheme, **kw)["time"]
    return t / base


# --------------------------------------------------------------------------
# building workloads from the paper's CNNs
# --------------------------------------------------------------------------

def cnn_workload(cfg: CNNConfig, ratio: float = 0.5,
                 protect_boundary: bool = True,
                 img_size: int = 224) -> List[LayerWork]:
    """Per-layer work items with SE encryption fractions.

    Output-FM encrypted channels of layer l = encrypted input channels of
    the next weight layer (the FM is written once, read by the consumer);
    pool layers pass fractions through (paper Fig 5 semantics).
    """
    traffic = layer_traffic(cfg.with_(img_size=img_size))
    conv_ids = [i for i, t in enumerate(traffic) if t["kind"] == "conv"]
    fc_ids = [i for i, t in enumerate(traffic) if t["kind"] == "fc"]
    always_full = set(conv_ids[:2] + conv_ids[-1:] + fc_ids) if protect_boundary else set()

    n = len(traffic)
    in_frac = [1.0] * n
    # encrypted fraction of a weight layer's input rows
    row_frac = {i: (1.0 if i in always_full else ratio)
                for i in conv_ids + fc_ids}
    # input FM of layer i is encrypted according to layer i's rows;
    # propagate backwards through pools.
    frac_after = {}          # fraction of encrypted channels in each FM
    nxt = None
    for i in reversed(range(n)):
        if traffic[i]["kind"] in ("conv", "fc"):
            frac_after[i] = row_frac[i]
            nxt = row_frac[i]
        else:                # pool: its input FM feeds the next weight layer
            frac_after[i] = nxt if nxt is not None else 1.0

    out: List[LayerWork] = []
    for i, t in enumerate(traffic):
        fin = frac_after[i]
        fout = frac_after[i + 1] if i + 1 < n else 1.0
        if t["kind"] in ("conv", "fc"):
            fw = row_frac[i]
        else:
            fw = 0.0
        out.append(LayerWork(kind=t["kind"], macs=t["macs"],
                             w_bytes=t["weight_bytes"],
                             in_bytes=t["in_fm_bytes"],
                             out_bytes=t["out_fm_bytes"],
                             enc_frac_w=fw, enc_frac_in=fin, enc_frac_out=fout))
    return out


def gemm_workload(n: int = 2048) -> List[LayerWork]:
    """The §2.4 raw matrix-multiply benchmark."""
    return [LayerWork(kind="gemm", macs=float(n) ** 3,
                      w_bytes=4.0 * n * n, in_bytes=4.0 * n * n,
                      out_bytes=4.0 * n * n)]


def vgg_conv_layers(ratio: float = 0.5) -> Dict[int, LayerWork]:
    """The four Fig-10 conv layers (64/128/256/512 in==out channels)."""
    layers = cnn_workload(vggc(), ratio=ratio)
    traffic = layer_traffic(vggc().with_(img_size=224))
    picked = {}
    for ch in (64, 128, 256, 512):
        for i, t in enumerate(traffic):
            if t["kind"] == "conv" and t["in_ch"] == ch and t["out_ch"] == ch:
                picked[ch] = layers[i]
                break
    return picked


def vgg_pool_layers(ratio: float = 0.5) -> List[LayerWork]:
    layers = cnn_workload(vggc(), ratio=ratio)
    return [l for l in layers if l.kind == "pool"]
