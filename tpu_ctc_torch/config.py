"""Configuration tree of the PyTorch/CUDA port (a copy of ``tpu_ctc.config``).

The presets, field names and ``override`` semantics are the JAX package's,
unchanged, so one preset name means one model in both packages.

Replaces the reference's `optparse` flags in ``runNNet.py`` plus the
hard-coded constants in ``decoder_config.py``-style modules (SURVEY.md §5
"Config/flag system") with a single serializable dataclass tree.  The five
BASELINE configs are checked in as named presets (``PRESETS``).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class FrontendConfig:
    """STFT → log-mel filterbank frontend (reference: Kaldi fbank, SURVEY C12/C13)."""

    sample_rate: int = 16000
    frame_length: int = 400        # 25 ms @ 16 kHz
    hop_length: int = 160          # 10 ms @ 16 kHz
    n_fft: int = 512
    n_mels: int = 40
    fmin: float = 20.0
    fmax: Optional[float] = None   # defaults to sample_rate / 2
    log_floor: float = 1e-10
    # Context stacking: +/- k neighbouring frames concatenated, as the
    # reference's dataLoader did (SURVEY C7 "stacks +/-k context frames").
    context: int = 0
    # Frame subsampling applied AFTER context stacking: keep every k-th
    # frame.  Halving T halves the sequential recurrence length (the BiRNN
    # step-time dominator) with no information loss when context >= stride-1.
    # 1 = reference-faithful (no striding).
    frame_stride: int = 1
    cmvn: bool = True              # per-utterance mean/variance normalization
    # Kaldi-fbank-faithful options (PARITY.md "Frontend fidelity"):
    # pre-emphasis y[n] = x[n] - coeff*x[n-1] over the whole waveform
    # (0.0 disables; Kaldi default 0.97, applied per frame there — the
    # boundary-sample delta is documented), and dither = stddev of added
    # Gaussian noise in the waveform's own units (our audio is [-1, 1]
    # float, so Kaldi's default "1.0" on int16-scale is ~1/32768 here).
    preemphasis: float = 0.0
    dither: float = 0.0

    @property
    def feature_dim(self) -> int:
        return self.n_mels * (2 * self.context + 1)


@dataclass(frozen=True)
class ModelConfig:
    """Deep BiRNN acoustic model (reference: brnnet.py, SURVEY C4).

    Architecture family of Hannun et al. 2014: a stack of affine +
    clipped-ReLU feed-forward layers with bidirectional recurrent layers in
    the middle, and a final affine projection to ``vocab_size`` logits
    (vocab includes the CTC blank at index 0).
    """

    input_dim: int = 40
    hidden_dim: int = 512
    num_pre_layers: int = 1        # feed-forward layers before the BiRNN stack
    num_bi_layers: int = 1         # recurrent layers (0 = pure feedforward,
    #                                the reference's earlier-gen nnet.py)
    num_post_layers: int = 0       # feed-forward layers after the BiRNN stack
    # False = forward-only recurrence (the reference's earlier-gen
    # rnn/rnnet.py unidirectional model family).
    bidirectional: bool = True
    vocab_size: int = 29           # blank + 26 letters + space + apostrophe
    relu_clip: float = 20.0        # clipped-ReLU ceiling, reference-faithful
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"  # matmul inputs; accumulation is f32
    init_scale: float = 0.01       # reference-era scaled gaussian init
    # Rematerialize each BiRNN layer's scan to trade FLOPs for HBM.
    remat: bool = False
    # Recurrence implementation: "scan" (the plain per-frame loop), or
    # "auto" (the CUDA kernel of ops/birnn_cuda.py on a CUDA tensor, the
    # plain loop on a CPU tensor).  "pallas" means "auto" here.
    birnn_impl: str = "auto"
    # HBM stream dtype for the fused kernel's z/h/g/delta tensors; ""
    # follows compute_dtype.  "float32" costs ~15% step time for exact
    # scan-parity gradients; matmul accumulation is float32 either way.
    birnn_io_dtype: str = ""


@dataclass(frozen=True)
class OptimConfig:
    """SGD + Nesterov momentum (reference: sgd.py, SURVEY C5)."""

    learning_rate: float = 1e-2
    momentum: float = 0.95
    nesterov: bool = True
    # Momentum ramp: linearly increase momentum from ``momentum_start`` over
    # ``momentum_ramp_steps`` steps (the reference's ramp-up schedule).
    momentum_start: float = 0.5
    momentum_ramp_steps: int = 0
    grad_clip_norm: float = 5.0    # global-norm clipping
    # Staircase exponential decay: lr *= lr_decay every lr_decay_steps
    # steps (0 disables) — the reference's per-epoch anneal, step-based.
    lr_decay: float = 1.0
    lr_decay_steps: int = 0
    weight_decay: float = 0.0


@dataclass(frozen=True)
class DataConfig:
    batch_size: int = 32
    max_frames: int = 1600         # longest utterance (frames) after bucketing
    max_label_len: int = 256
    # Bucket boundaries on frame counts; each batch is padded to its bucket.
    bucket_boundaries: Tuple[int, ...] = (200, 400, 800, 1600)
    shuffle: bool = True
    seed: int = 0
    # Sortagrad-style curriculum: first epoch sorted by length.
    sortagrad: bool = True


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh (SURVEY §2.2): axes ('data', 'model', 'seq')."""

    data: int = -1                 # -1: all remaining devices
    model: int = 1
    seq: int = 1
    # Pipeline parallelism (SURVEY P3): when True, the 'model' axis carries
    # GPipe-style pipeline STAGES of the BiRNN stack instead of tensor
    # sharding; activations flow between stages via ppermute in
    # ``pipeline_microbatches`` microbatches.
    pipeline: bool = False
    pipeline_microbatches: int = 4


@dataclass(frozen=True)
class DecodeConfig:
    """Prefix beam search + char LM fusion (reference: ctc_fast/decoder, SURVEY C9/C10)."""

    beam_width: int = 64
    lm_alpha: float = 1.0          # LM weight
    lm_beta: float = 1.5           # word/char insertion bonus
    lm_order: int = 3              # char n-gram order (0 disables the LM)
    # Acoustic pruning of extension chars (the reference decoder's
    # probability threshold, SURVEY C9); None disables.
    prune_logp: Optional[float] = -12.0
    # Static per-frame extension-char cap: only the top-C chars by
    # acoustic log-prob become beam extensions (0 = exact, all chars).
    # Shrinks the per-frame candidate set from K*A to K*(C+1).
    char_topk: int = 0
    # Neural character LM (SURVEY C10, Maas NAACL'15): train an in-repo
    # GRU char LM on the train split's transcripts and fuse it into the
    # beam search (additively with the n-gram when lm_order > 0).  The
    # fused kernels take E <= 128 and H <= 256 after rounding each up to a
    # multiple of 8 (ops/beam_cuda.py pads them with zero weights).
    neural_lm: bool = False
    neural_lm_hidden: int = 128
    neural_lm_embed: int = 64
    neural_lm_steps: int = 300     # LM training steps (adam, in-repo)
    # Route CUDA tensors through the fused beam-search kernels
    # (ops/beam_cuda.py: K <= 256, vocab <= 64, n-gram order <= 3, the GRU
    # char LM within the dims above); anything else raises on CUDA, and on
    # the CPU (where the plain search runs) logs a warning.  False forces
    # the plain search.
    use_fused_kernel: bool = True


@dataclass(frozen=True)
class TrainConfig:
    num_epochs: int = 10
    # Debug: fail fast on NaN/Inf.  train_step raises FloatingPointError
    # when the loss or the gradient norm is not finite, before the update
    # (the reference's jax_debug_nans); off, it adds no host sync.
    debug_nans: bool = False
    log_every: int = 10
    checkpoint_every: int = 200
    eval_every: int = 200
    # Eval with prefix beam search + corpus WER every eval (expensive) in
    # addition to greedy CER; the reference only ever greedy-CER'd during
    # training and beam-decoded offline (SURVEY.md §3.3).
    eval_beam: bool = False
    checkpoint_dir: str = "checkpoints"
    metrics_path: str = "metrics.jsonl"
    keep_checkpoints: int = 3


@dataclass(frozen=True)
class Config:
    name: str = "default"
    seed: int = 0
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    # Which CTC implementation: "jnp" (lax.scan reference) or "pallas".
    ctc_impl: str = "auto"

    # ---- serialization ------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                fields = {f.name: f for f in dataclasses.fields(tp)}
                kwargs = {}
                for k, v in val.items():
                    if k not in fields:
                        raise KeyError(f"unknown config field {tp.__name__}.{k}")
                    ftp = fields[k].type
                    sub = _FIELD_TYPES.get((tp.__name__, k))
                    if sub is not None:
                        kwargs[k] = build(sub, v)
                    elif isinstance(v, list):
                        kwargs[k] = tuple(v)
                    else:
                        kwargs[k] = v
                return tp(**kwargs)
            return val

        return build(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def override(self, **kw: Any) -> "Config":
        """Dotted-path overrides: Config().override(**{"model.hidden_dim": 256})."""
        d = self.to_dict()
        for path, val in kw.items():
            parts = path.split("__") if "__" in path else path.split(".")
            node = d
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config path {path}")
            node[parts[-1]] = val
        return Config.from_dict(d)


_FIELD_TYPES = {
    ("Config", "frontend"): FrontendConfig,
    ("Config", "model"): ModelConfig,
    ("Config", "optim"): OptimConfig,
    ("Config", "data"): DataConfig,
    ("Config", "mesh"): MeshConfig,
    ("Config", "decode"): DecodeConfig,
    ("Config", "train"): TrainConfig,
}


# ---------------------------------------------------------------------------
# The five BASELINE.json configs as named presets (BASELINE.md "configs").
# ---------------------------------------------------------------------------

def _preset_1() -> Config:
    """1-layer BiRNN + CTC char-level on TIMIT subset (CPU-runnable)."""
    return Config(
        name="timit_subset_1layer",
        frontend=FrontendConfig(n_mels=23, context=1),
        model=ModelConfig(input_dim=23 * 3, hidden_dim=128, num_pre_layers=1,
                          num_bi_layers=1, compute_dtype="float32"),
        data=DataConfig(batch_size=8, max_frames=400,
                        bucket_boundaries=(100, 200, 400)),
        optim=OptimConfig(learning_rate=5e-3),
    )


def _preset_2() -> Config:
    """3-layer BiRNN + CTC, filterbank features, TIMIT full, single chip."""
    return Config(
        name="timit_full_3layer",
        frontend=FrontendConfig(n_mels=40, context=1),
        model=ModelConfig(input_dim=40 * 3, hidden_dim=1024, num_pre_layers=1,
                          num_bi_layers=3),
        data=DataConfig(batch_size=32, max_frames=800,
                        bucket_boundaries=(200, 400, 800)),
    )


def _preset_3() -> Config:
    """5-layer deep BiRNN + CTC char-level, Switchboard 300h, DP over 1 host."""
    return Config(
        name="swbd_5layer_dp",
        frontend=FrontendConfig(n_mels=40, context=1),
        model=ModelConfig(input_dim=40 * 3, hidden_dim=1824, num_pre_layers=2,
                          num_bi_layers=5),
        data=DataConfig(batch_size=64, max_frames=1600),
        mesh=MeshConfig(data=-1, model=1),
    )


def _preset_4() -> Config:
    """BiRNN + CTC with batched prefix beam-search decode + char-LM rescoring."""
    c = _preset_3()
    return dataclasses.replace(
        c, name="swbd_beam_decode",
        decode=DecodeConfig(beam_width=128, lm_alpha=1.25, lm_beta=1.5,
                            lm_order=3))


def _preset_5() -> Config:
    """Wide BiRNN (model-sharded) on Switchboard, multi-host pod slice."""
    return Config(
        name="swbd_wide_tp",
        frontend=FrontendConfig(n_mels=40, context=1),
        model=ModelConfig(input_dim=40 * 3, hidden_dim=4096, num_pre_layers=2,
                          num_bi_layers=5),
        data=DataConfig(batch_size=64, max_frames=1600),
        mesh=MeshConfig(data=-1, model=4),
    )


PRESETS: Dict[str, Config] = {
    c.name: c for c in (_preset_1(), _preset_2(), _preset_3(), _preset_4(), _preset_5())
}
# BASELINE.json ordinal aliases.
PRESETS["1"] = _preset_1()
PRESETS["2"] = _preset_2()
PRESETS["3"] = _preset_3()
PRESETS["4"] = _preset_4()
PRESETS["5"] = _preset_5()


def get_config(name: str = "default", **overrides: Any) -> Config:
    if name == "default":
        cfg = Config()
    elif name in PRESETS:
        cfg = PRESETS[name]
    else:
        raise KeyError(
            f"unknown config preset {name!r}; available: "
            f"{sorted(k for k in PRESETS if not k.isdigit())} or 1-5")
    if overrides:
        cfg = cfg.override(**overrides)
    return cfg
