"""Serving mode: an HTTP video-generation endpoint on a streaming pipeline
(port of ``vdpp_tpu/modes/serve.py``).

Requests that arrive over time keep the stage pipeline filled
(``parallel/pipeline.py``: :class:`StreamRanks` and :class:`PipelineStream`):
a request submitted while another is in transit finishes one tick after it,
not a whole pipeline later. The stage ranks start once per server, each
loading the whole model, and wait on their command channels between
requests; a conditioning (one per (frames, guidance[, prompt, negative
prompt])) is sent to them once and kept there under an LRU cap, and samples
of different conditionings share ticks. One stage with no decode ranks and no
intra-sample axis runs in this process, with no process group. The VAE decode
happens outside the stream: in the request's thread, on the first stage's
device, where a tick that meets it waits for it (they share the card), or
with ``--decode-devices N`` on N reserved decode ranks, which the last stage
posts each finished latent to, so that ticks never queue behind a decode.

    POST /generate  {"seed": 42, "num_frames": 4, "guidance_scale": 3.0,
                     "prompt": "...", "negative_prompt": "...",
                     "format": "y4m"|"gif"}
        -> video bytes (y4m/gif from the native packer)
    GET  /healthz   -> {"status": "ok", ...} (503 {"status": "draining"}
                       once a shutdown signal has been received)
    GET  /metrics   -> request counters and a rolling latency window

SIGTERM and SIGINT drain instead of killing: /healthz turns 503, new
/generate requests are refused with 503, the requests in flight finish, and
the process exits 0. The ranks ignore both signals and leave when the server
stops them, or when it dies.

``--model svd`` (the default) serves the SVD UNet on a random dummy
conditioning drawn from ``--seed`` + 2; ``--model dit3d`` the T5-conditioned
joint-3D DiT, the "prompt" field choosing the conditioning. Weights are
drawn from ``--seed`` (the model), + 1 (the VAE decoder) and + 3 (T5), or
read from ``--checkpoint DIR``, a directory of the JAX package's
``save_params`` files (``unet.npz`` or ``dit.npz``, and ``vae_decoder.npz``).
Noise is drawn on the CPU from the request's seed, so the same seed gives
the same bytes for any layout of the ranks. Entry points run on the card
unless ``--device cpu`` is asked for; ``--devices`` names a device a rank
(a card named more than once is shared over gloo).

The reference's default latent (``--latent-hw 16 16``, ``--num-frames 4``)
puts every attention below the flash route's L = 512, so no kernel runs
there; ``--preset svd_xt --num-frames 14 --latent-hw 72 128`` is the
image->video app's shape.

Example:
    python -m vdpp_tpu_torch.modes.serve --preset tiny --device cpu \\
        --num-stages 4 --steps 8 --port 8787
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import logging
import os
import sys
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from vdpp_tpu_torch.parallel.mesh import make_pipeline_and_decode_mesh
from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StreamJob, StreamRanks
from vdpp_tpu_torch.utils.kernels import launch_counts, launches_since
from vdpp_tpu_torch.utils.memory import peak_memory_gb
from vdpp_tpu_torch.utils.video_io import frames_to_uint8

LOGGER = logging.getLogger("vdpp_torch.serve")

# Per-request frame ceiling: each distinct num_frames is a stream of its own
# (LRU-capped), so an unbounded value would let one client churn the cache.
MAX_FRAMES_PER_REQUEST = 64
DECODE_CHUNK_FRAMES = 4

# Weight seeds, as the reference draws them: the model, the VAE decoder, the
# SVD dummy conditioning, T5.
_SEED_OFFSET = {"model": 0, "vae_decoder": 1, "conditioning": 2, "t5": 3}


class BadRequest(ValueError):
    """Client-input validation failure -> HTTP 400. Only this type maps to
    400: a ValueError raised deeper in the generate path is an internal error
    (500, traceback logged)."""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--model", default="svd", choices=["svd", "dit3d"])
    p.add_argument("--preset", default="tiny", choices=["svd_xt", "full", "tiny"])
    p.add_argument("--checkpoint", default=None,
                   help="directory of the JAX package's weight files (unet.npz or dit.npz, "
                        "and vae_decoder.npz)")
    p.add_argument("--num-stages", type=int, default=None)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--num-frames", type=int, default=4)
    p.add_argument("--latent-hw", type=int, nargs=2, default=[16, 16], metavar=("H", "W"))
    p.add_argument("--guidance-scale", type=float, default=None)
    p.add_argument("--solver", default="euler",
                   choices=["euler", "euler_a", "heun", "dpmpp2m", "flowmatch"],
                   help="ODE solver; flowmatch = rectified flow (--model dit3d only)")
    p.add_argument("--deepcache", type=int, default=0, metavar="N",
                   help="SVD only: the whole UNet every N steps (0 = off; changes outputs)")
    p.add_argument("--deepcache-split", type=int, default=1,
                   help="shallow levels the cache steps still compute")
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="token/W sharding width per stage (DiT: token shards; SVD: "
                        "halo-exchange W shards)")
    p.add_argument("--frame-parallel", type=int, default=1,
                   help="frame sharding width per stage (SVD models); --num-frames must "
                        "divide by it")
    p.add_argument("--decode-devices", type=int, default=0,
                   help="reserve this many ranks (after the stage ranks) for the VAE decode, "
                        "so that ticks never queue behind decode work")
    p.add_argument("--fps", type=int, default=7)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--devices", nargs="+", default=None, metavar="DEV",
                   help="an explicit device per rank, in rank order; a card named more than "
                        "once is shared by its ranks over gloo")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sampler-seed", type=int, default=0,
                   help="euler_a only: seed of the per-step injected noise")
    p.add_argument("--log-level", default="INFO")
    return p


# ---- models: built on the ranks and, for T5 and the decode, in the server ---- #


def _configs(args: argparse.Namespace):
    """The preset's (model config, VAE config, T5 config or None)."""
    from vdpp_tpu_torch.models.vae import VAEConfig

    tiny = args.preset == "tiny"
    vae_cfg = VAEConfig.tiny() if tiny else VAEConfig.svd()
    if args.model == "dit3d":
        from vdpp_tpu_torch.models.dit import DiTVideoConfig
        from vdpp_tpu_torch.models.t5_encoder import T5EncoderConfig

        t5_cfg = T5EncoderConfig.tiny() if tiny else T5EncoderConfig.xxl()
        base = DiTVideoConfig.joint3d_tiny() if tiny else DiTVideoConfig.joint3d_xl()
        return dataclasses.replace(base, cross_attention_dim=t5_cfg.d_model), vae_cfg, t5_cfg
    from vdpp_tpu_torch.models.svd_unet import SVDUNetConfig

    return (SVDUNetConfig.tiny() if tiny else SVDUNetConfig.svd_xt()), vae_cfg, None


def make_wrapper(args: argparse.Namespace, device):
    """The model's schedule and step (no weights)."""
    cfg = _configs(args)[0]
    if args.model == "dit3d":
        from vdpp_tpu_torch.models.dit import DiTVideoWrapper

        return DiTVideoWrapper(cfg, num_steps=args.steps, solver=args.solver,
                               sampler_seed=args.sampler_seed, device=device)
    from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet

    return StableVideoUNet(cfg, num_steps=args.steps, solver=args.solver,
                           sampler_seed=args.sampler_seed, deepcache_interval=args.deepcache,
                           deepcache_split=args.deepcache_split, device=device)


def _weights(args: argparse.Namespace, module: torch.nn.Module, name: str, carry, seed: int):
    """``module`` with ``--checkpoint``'s ``<name>.npz`` or weights drawn from
    ``seed`` on its device."""
    from vdpp_tpu_torch.utils.weights import load_jax_npz

    if args.checkpoint:
        module.load_state_dict(carry(load_jax_npz(os.path.join(args.checkpoint, f"{name}.npz"))))
    else:
        dev = next(module.parameters()).device
        module.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return module


def load_vae_decoder(args: argparse.Namespace, device):
    from vdpp_tpu_torch.models.vae import TemporalVAEDecoder
    from vdpp_tpu_torch.utils.weights import from_jax_vae_decoder_params

    return _weights(args, TemporalVAEDecoder(_configs(args)[1], device=device), "vae_decoder",
                    from_jax_vae_decoder_params, args.seed + _SEED_OFFSET["vae_decoder"])


def load_t5(args: argparse.Namespace, device):
    """The T5 encoder, drawn from ``--seed`` + 3 (the reference reads no T5
    checkpoint here either)."""
    from vdpp_tpu_torch.models.t5_encoder import T5TextEncoder

    t5 = T5TextEncoder(_configs(args)[2], device=device)
    return t5.init_weights(torch.Generator(device=device).manual_seed(
        args.seed + _SEED_OFFSET["t5"]))


def draw_noise(seed: int, shape: tuple) -> torch.Tensor:
    """A request's standard-normal latent noise, drawn on the CPU."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def dummy_conditioning(args: argparse.Namespace, num_frames: int, guidance):
    """The SVD dummy conditioning of a stream, drawn on the CPU from
    ``--seed`` + 2."""
    from vdpp_tpu_torch.models.svd_wrapper import make_dummy_conditioning

    h, w = args.latent_hw
    return make_dummy_conditioning(
        torch.Generator().manual_seed(args.seed + _SEED_OFFSET["conditioning"]), 1, num_frames,
        h, w, cross_dim=_configs(args)[0].cross_attention_dim, guidance_scale=guidance)


class _Bundle:
    """A stream's conditioning payload (CPU tensors) -> the step's bundle on
    this rank: ``(unet, cond)`` or ``(dit, context, guidance)``."""

    def __init__(self, model: torch.nn.Module, device: torch.device, dit: bool):
        self.model, self.device, self.dit = model, device, dit

    def _to(self, v):
        if isinstance(v, tuple):
            return tuple(self._to(x) for x in v)
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{f.name: self._to(getattr(v, f.name))
                                             for f in dataclasses.fields(v)})
        return v.to(self.device) if isinstance(v, torch.Tensor) else v

    def __call__(self, payload):
        if self.dit:
            context, guidance = payload
            return self.model, self._to(context), self._to(guidance)
        return self.model, self._to(payload)


class _Decode:
    """A decode rank's decode: chunk-parallel over the decode ranks, the
    frames (numpy, ``(F, H, W, 3)``, uint8 when asked) on decode rank 0."""

    def __init__(self, decoder):
        self.decoder = decoder

    def __call__(self, latent: torch.Tensor, stage, uint8: bool):
        dec = self.decoder
        latent = latent.to(stage.device) / dec.config.scaling_factor
        video = dec.decode_data_parallel(latent, stage.decode_axis, DECODE_CHUNK_FRAMES)
        if video is None:
            return None
        frames = video[0].float().cpu().numpy()
        return frames_to_uint8(frames) if uint8 else frames


def serve_job(stage, args: argparse.Namespace) -> StreamJob:
    """A rank's part of the server: a stage rank builds the model (from the
    checkpoint or the seed) and steps its slice; a decode rank builds the VAE
    decoder."""
    dev = stage.device
    if dev.type == "cuda":  # the same bits in every process, for any layout
        torch.backends.cudnn.deterministic = True
    if stage.is_decode:
        return StreamJob(decode=_Decode(load_vae_decoder(args, dev)))
    wrapper = make_wrapper(args, dev)
    if args.model == "dit3d":
        from vdpp_tpu_torch.models.dit import DiTVideo
        from vdpp_tpu_torch.utils.weights import from_jax_dit_params

        model = _weights(args, DiTVideo(wrapper.config, device=dev), "dit", from_jax_dit_params,
                         args.seed + _SEED_OFFSET["model"])
    else:
        from vdpp_tpu_torch.models.svd_unet import SVDUNet
        from vdpp_tpu_torch.utils.weights import from_jax_params

        model = _weights(args, SVDUNet(wrapper.config, device=dev), "unet", from_jax_params,
                         args.seed + _SEED_OFFSET["model"])
    return StreamJob(wrapper.pipeline_step_fn(**stage.axes), args.steps,
                     bundle=_Bundle(model, dev, args.model == "dit3d"),
                     pack=wrapper.pack_initial, unpack=wrapper.unpack_final)


# ---- the engine ------------------------------------------------------------ #


class _Engine:
    """Owns the ranks, the streams, T5 and the server-side decode."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        # Flipped by the SIGTERM/SIGINT drain handler: /healthz turns 503, new
        # /generate requests are refused, the ones in flight finish.
        self.draining = False
        self.is_dit = args.model == "dit3d"
        # Argument checks before any model is built (minutes on a card).
        fp, sp = args.frame_parallel, args.seq_parallel
        if fp > 1 and self.is_dit:
            raise SystemExit("--frame-parallel serves the SVD family only (the DiT token axis "
                             "already covers frames via --seq-parallel)")
        if args.solver == "flowmatch" and not self.is_dit:
            raise SystemExit("--solver flowmatch serves the DiT family only: SVD's published "
                             "weights are v-prediction EDM, a different parameterization from "
                             "rectified flow (--model dit3d)")
        if fp > 1 and args.num_frames % fp != 0:
            raise SystemExit(f"--frame-parallel {fp}: --num-frames {args.num_frames} must "
                             "divide by it")
        if self.is_dit and args.deepcache:
            raise SystemExit("--deepcache is implemented for the SVD UNet family only (the DiT "
                             "has no encoder-decoder skip structure to cache across)")
        self.mesh = make_pipeline_and_decode_mesh(args.num_stages, args.decode_devices,
                                                  device=args.device, devices=args.devices,
                                                  seq=sp, frame=fp)
        self.stages = self.mesh.num_stages
        PipelineConfig(args.steps, self.stages)  # a bad split fails before any rank starts
        self.device = self.mesh.devices[0]
        if self.device.type == "cuda":
            torch.backends.cudnn.deterministic = True
        self.wrapper = make_wrapper(args, self.device)
        self.t5 = load_t5(args, self.device) if self.is_dit else None
        self.vae_dec = None if self.mesh.decode else load_vae_decoder(args, self.device)
        self.ranks = StreamRanks(self.mesh, serve_job, args)
        self.lock = threading.Lock()  # streams, contexts and counters
        self._ranks_lock = threading.Lock()
        self.requests_served = 0
        # LRU caps: every distinct conditioning is a stream whose bundle the
        # stage ranks hold, and every distinct prompt a T5 context; both come
        # from client input, so both are bounded.
        self.max_streams = int(os.environ.get("VDPP_SERVE_MAX_STREAMS", "4"))
        self.max_ctx_cache = int(os.environ.get("VDPP_SERVE_MAX_PROMPTS", "32"))
        self._streams: OrderedDict = OrderedDict()  # key -> PipelineStream
        self._ctx_cache: OrderedDict = OrderedDict()  # (prompt, negative) -> context
        self._latencies: deque = deque(maxlen=512)
        self._mark = launch_counts()
        LOGGER.info("engine ready: %s, %d stages, %d steps, %d rank(s) on %s", args.model,
                    self.stages, args.steps, self.mesh.world_size,
                    ", ".join(map(str, self.mesh.devices)))

    def _text_context(self, prompt: str, negative: str | None = None):
        """T5-encode a prompt with the hash tokenizer, cached per (prompt,
        negative); with a negative prompt a ``(neg_ctx, pos_ctx)`` tuple, both
        id lists EOS-padded to one length. CPU tensors."""
        key = (prompt, negative)
        with self.lock:
            if key in self._ctx_cache:
                self._ctx_cache.move_to_end(key)
                return self._ctx_cache[key]
        from vdpp_tpu_torch.models.t5_encoder import hash_tokenize

        cfg = self.t5.config
        pos = hash_tokenize(prompt, cfg.vocab_size, 64)

        def encode(ids):
            with torch.inference_mode():
                return self.t5(torch.tensor([ids], device=self.device)).float().cpu()

        if negative is None:
            ctx = encode(pos)
        else:
            neg = hash_tokenize(negative, cfg.vocab_size, 64)
            eos = cfg.vocab_size - 1
            want = max(len(pos), len(neg))
            ctx = (encode(neg + [eos] * (want - len(neg))),
                   encode(pos + [eos] * (want - len(pos))))
        with self.lock:
            self._ctx_cache[key] = ctx
            while len(self._ctx_cache) > self.max_ctx_cache:
                self._ctx_cache.popitem(last=False)
        return ctx

    def _live_ranks(self) -> StreamRanks:
        """The ranks, started anew if a failure stopped them (every stream of
        the old group is then unusable)."""
        with self._ranks_lock:
            if self.ranks.failed:
                LOGGER.warning("stream ranks failed (%r): starting new ones",
                               self.ranks.controller.failure)
                self.ranks.close()
                self.ranks = StreamRanks(self.mesh, serve_job, self.args)
            return self.ranks

    def _get_stream(self, num_frames: int, guidance, prompt, negative=None):
        """One stream per conditioning; requests with the same one share it."""
        args = self.args
        h, w = args.latent_hw
        key = (num_frames, guidance, prompt if self.is_dit else None,
               negative if self.is_dit else None)
        with self.lock:
            cached = self._streams.get(key)
            if cached is not None:
                if cached.unusable:  # poisoned or closed: evict and rebuild below
                    del self._streams[key]
                else:
                    self._streams.move_to_end(key)
                    return cached
        if self.is_dit:
            from vdpp_tpu_torch.models.svd_wrapper import make_guidance_ramp

            payload = (self._text_context(prompt or "", negative),
                       make_guidance_ramp(guidance, num_frames))
        else:
            payload = dummy_conditioning(args, num_frames, guidance)
        stream = self._live_ranks().stream(payload, (1, num_frames, h, w, 4), torch.float32)
        evicted = []
        with self.lock:
            winner = self._streams.setdefault(key, stream)
            self._streams.move_to_end(key)
            while len(self._streams) > self.max_streams:
                evicted.append(self._streams.popitem(last=False)[1])
        if winner is not stream:  # lost a concurrent creation race
            stream.close()
        for old in evicted:
            old.close()  # its ranks drop the bundle once its samples are done
        return winner

    def generate(self, seed: int, num_frames: int, guidance, prompt=None, negative=None,
                 as_uint8: bool = False):
        """One video: ``(frames (F, H, W, 3), seconds)``, float in [-1, 1] or,
        with ``as_uint8``, bytes (a decode rank converts them itself)."""
        if negative is not None and not self.is_dit:
            raise BadRequest("negative_prompt conditions the DiT text family only (the SVD "
                             "preset is image-conditioned)")
        if negative is not None and (guidance is None or guidance <= 1.0):
            # CFG is off at <= 1.0: the negative context would be ignored.
            raise BadRequest(f"negative_prompt needs CFG: set guidance_scale > 1.0 (got "
                             f"{guidance})")
        args = self.args
        h, w = args.latent_hw
        fp = args.frame_parallel
        if fp > 1 and num_frames % fp != 0:
            raise BadRequest(f"num_frames {num_frames} must divide by --frame-parallel {fp}")
        stream = self._get_stream(num_frames, guidance, prompt, negative)
        noise = draw_noise(seed, (1, num_frames, h, w, 4)) * self.wrapper.init_noise_sigma
        t0 = time.perf_counter()
        # The denoise goes through the shared stream; the decode happens
        # outside it. A stream may be evicted (or its ranks fail) between the
        # lookup and the submit: take it again and retry.
        for attempt in range(3):
            try:
                if self.mesh.decode:
                    out = stream.submit_decoded(noise, uint8=as_uint8).result(timeout=1800)
                else:
                    out = stream.submit(noise).result(timeout=1800)
                break
            except RuntimeError:
                if attempt == 2:
                    raise
                stream = self._get_stream(num_frames, guidance, prompt, negative)
        video = out if self.mesh.decode else self._decode(out, as_uint8)
        elapsed = time.perf_counter() - t0
        with self.lock:
            self.requests_served += 1
            self._latencies.append(elapsed)
        return video, elapsed

    def _decode(self, latent: torch.Tensor, as_uint8: bool) -> np.ndarray:
        """The decode in the request's thread, on the first stage's device."""
        latent = latent.to(self.device) / self.vae_dec.config.scaling_factor
        video = self.vae_dec.decode_chunked(latent, DECODE_CHUNK_FRAMES)[0]
        video = video.float().cpu().numpy()
        return frames_to_uint8(video) if as_uint8 else video

    def metrics(self) -> dict:
        """Counters and the latency distribution over a rolling 512-request
        window."""
        with self.lock:
            lats = sorted(self._latencies)
            n_streams = len(self._streams)
            served = self.requests_served

        def pct(p: float) -> float:
            if not lats:
                return 0.0
            return lats[min(int(p * (len(lats) - 1)), len(lats) - 1)]

        return {
            "requests_served": served,
            "active_streams": n_streams,
            "window": len(lats),
            "latency_s": {
                "mean": sum(lats) / len(lats) if lats else 0.0,
                "p50": pct(0.50),
                "p95": pct(0.95),
                "max": lats[-1] if lats else 0.0,
            },
        }

    def mark_launches(self) -> None:
        """Count every process's kernel launches from now on."""
        self.ranks.mark()
        self._mark = launch_counts()

    def close(self) -> None:
        """Log each process's kernel launches since the mark and the ticks,
        then stop the ranks (the samples submitted finish first)."""
        ranks = self.ranks
        if not ranks.failed:
            mesh = self.mesh
            for r, (counts, peak) in enumerate(ranks.launches()):
                LOGGER.info("rank %d (%s%s) launched since the warm-up: %s; peak allocated "
                            "%.3f GB", r, mesh.devices[r],
                            ", decode" if r >= mesh.stage_ranks else "", json.dumps(counts), peak)
            if mesh.world_size > 1:
                LOGGER.info("server process (%s) launched since the warm-up: %s; peak allocated "
                            "%.3f GB", self.device, json.dumps(launches_since(self._mark)),
                            peak_memory_gb(self.device))
        ticks = list(ranks.controller.tick_seconds)
        if ticks:
            LOGGER.info("stream: %d ticks, tick seconds mean %.4f, min %.4f, max %.4f",
                        ranks.ticks_run, sum(ticks) / len(ticks), min(ticks), max(ticks))
        ranks.close()


def _video_bytes(frames_u8: np.ndarray, fmt: str, fps: int) -> tuple[bytes, str]:
    """The frames as y4m or gif bytes from the native packer (gif through
    imageio where no compiler builds it)."""
    import tempfile

    from vdpp_tpu_torch.utils.native import write_gif_native, write_y4m

    suffix = "." + fmt
    with tempfile.NamedTemporaryFile(suffix=suffix) as f:
        if fmt == "y4m":
            write_y4m(f.name, frames_u8, fps=fps)
            return open(f.name, "rb").read(), "video/x-yuv4mpeg"
        if write_gif_native(f.name, frames_u8, fps=fps):
            return open(f.name, "rb").read(), "image/gif"
    import imageio.v3 as iio

    buf = io.BytesIO()
    iio.imwrite(buf, frames_u8, extension=".gif", duration=int(1000 / fps), loop=0)
    return buf.getvalue(), "image/gif"


def _make_handler(engine: _Engine, fps: int):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):
            LOGGER.info("%s " + fmt, self.client_address[0], *a)

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                if engine.draining:
                    self._json(503, {"status": "draining"})
                    return
                self._json(200, {
                    "status": "ok",
                    "stages": engine.stages,
                    "steps": engine.args.steps,
                    "decode_devices": engine.args.decode_devices,
                    "requests_served": engine.requests_served,
                })
            elif self.path == "/metrics":
                self._json(200, engine.metrics())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "unknown path"})
                return
            if engine.draining:
                self._json(503, {"error": "server is draining"})
                return
            try:
                try:
                    # decoding and checking the parameters: failures here are
                    # the client's, anything after is ours
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    seed = int(req.get("seed", 0))
                    frames = int(req.get("num_frames", engine.args.num_frames))
                    if not 1 <= frames <= MAX_FRAMES_PER_REQUEST:
                        raise BadRequest(f"num_frames {frames} out of range "
                                         f"[1, {MAX_FRAMES_PER_REQUEST}]")
                    guidance = req.get("guidance_scale", engine.args.guidance_scale)
                    if guidance is not None:
                        guidance = float(guidance)
                    prompt = req.get("prompt")
                    negative = req.get("negative_prompt")
                    fmt = req.get("format", "gif")
                    if fmt not in ("gif", "y4m"):
                        raise BadRequest(f"format {fmt!r}: use 'gif' or 'y4m'")
                except (ValueError, TypeError, json.JSONDecodeError) as e:
                    raise BadRequest(str(e)) from e
                frames_u8, elapsed = engine.generate(seed, frames, guidance, prompt, negative,
                                                     as_uint8=True)
                data, ctype = _video_bytes(frames_u8, fmt, fps)
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("X-Generation-Seconds", f"{elapsed:.3f}")
                self.end_headers()
                self.wfile.write(data)
            except BadRequest as e:  # bad request parameters only
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # internal errors -> 500 + traceback
                LOGGER.exception("generate failed")
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _DrainingServer(ThreadingHTTPServer):
    """A ThreadingHTTPServer that drains on shutdown: request threads are
    non-daemon and ``server_close()`` joins them, so a SIGTERM never cuts a
    video half made."""

    daemon_threads = False
    block_on_close = True


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from vdpp_tpu_torch.utils.logging import setup_logging

    setup_logging(args.log_level)
    engine = _Engine(args)
    try:
        # Warm up first, so that the first request is not an outlier.
        engine.generate(0, args.num_frames, args.guidance_scale)
        engine.mark_launches()
        LOGGER.info("warmed; serving on http://%s:%d", args.host, args.port)
        server = _DrainingServer((args.host, args.port), _make_handler(engine, args.fps))

        def _drain(signum, frame):
            # Handler context: set the flag and hand off; shutdown() must run
            # on another thread (it joins serve_forever's loop).
            engine.draining = True
            LOGGER.info("signal %d: draining: healthz 503, new requests refused, requests "
                        "in flight finishing", signum)
            threading.Thread(target=server.shutdown, daemon=True).start()

        import signal

        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            LOGGER.info("shutting down")
        server.server_close()  # joins the handler threads in flight
    finally:
        engine.close()
    LOGGER.info("drained; exiting")
    return 0


if __name__ == "__main__":
    sys.exit(main())
