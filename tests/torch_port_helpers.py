"""Helpers shared by the port's parity tests (``tests/test_torch_port_*.py``)."""

import numpy as np
import pytest
import torch


def random_state_dict(module: torch.nn.Module, seed: int,
                      mix_base: float = 0.0) -> dict[str, np.ndarray]:
    """Checkpoint-named weights for ``module`` from a numpy seed: matrices and
    kernels LeCun-normal over their fan-in, norm scales (1-D ``.weight``)
    near 1, biases and embeddings near 0, mix factors near ``mix_base``. Off
    the values an init gives, so a misplaced one shows."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in module.state_dict().items():
        noise = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        if p.ndim >= 2:
            sd[name] = noise / np.sqrt(p[0].numel())
        else:
            base = mix_base if name.endswith("mix_factor") else float(name.endswith(".weight"))
            sd[name] = (base + 0.1 * noise).astype(np.float32)
    return sd


def tiny_svd_weights(seed: int = 0):
    """``(JAX params, port state dict)`` of ``SVDUNetConfig.tiny()`` holding
    the same weights: :func:`random_state_dict` (mix factors near 0.5)
    through the JAX package's converter, and back into the port's names
    through ``from_jax_params``. JAX is imported here, not at module level:
    spawned ranks import this module."""
    import jax
    import jax.numpy as jnp

    from vdpp_tpu.utils.weights import convert_unet_state_dict
    from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
    from vdpp_tpu_torch.utils.weights import from_jax_params

    sd = random_state_dict(SVDUNet(SVDUNetConfig.tiny(), device="meta"), seed, mix_base=0.5)
    params = jax.tree_util.tree_map(
        np.asarray, convert_unet_state_dict(sd, num_levels=2, layers_per_block=1,
                                            dtype=jnp.float32))
    return params, from_jax_params(params)


def dit_jax_params(jcfg, seed: int):
    """A JAX DiT tree for ``jcfg`` with every leaf drawn from a numpy seed:
    matrices and expert stacks N(0, 1) over their fan-in (the adaLN ones a
    tenth of that), norm scales near 1, biases near 0. JAX is imported here,
    not at module level: spawned ranks import this module."""
    import jax

    from vdpp_tpu.models.dit import DiTVideo

    shapes = jax.eval_shape(DiTVideo(jcfg).init, jax.random.key(0))
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim >= 2:
            leaves.append((0.1 if "ada" in name else 1.0) * noise / np.sqrt(leaf.shape[-2]))
        elif name.endswith("['scale']"):
            leaves.append(1.0 + 0.1 * noise)
        else:
            leaves.append(0.1 * noise)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def assert_quant_step_bounded(got, want, rel_bound: float = 0.06, cos_bound: float = 0.999):
    """Two W8A8 runs whose fp32 sums differ at the ulp level, held to the JAX
    package's bound (``tests/test_quant.py::_assert_quant_step_bounded``): a
    1-ulp difference at a rounding boundary moves an int8 value by a whole
    step, so relative L2 < 0.06 and cosine > 0.999, not elementwise."""
    a, b = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = np.linalg.norm(a - b) / np.linalg.norm(b)
    cos = (a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum())
    assert rel < rel_bound and cos > cos_bound, (rel, cos)


def _int8_view(tree, quantized, plain):
    """``tree`` with each int8 dict replaced by ``quantized(dict)`` (an array
    of the float weight's shape) and every other leaf by ``plain(leaf)``."""
    if isinstance(tree, dict):
        if "scale" in tree and ("q" in tree or "q8" in tree):
            return quantized(tree)
        return {k: _int8_view(v, quantized, plain) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_int8_view(v, quantized, plain) for v in tree)
    return plain(np.asarray(tree))


def assert_quantized_like_jax(port: torch.nn.Module, jax_tree, convert) -> dict[str, int]:
    """``port`` (quantized by ``quantize_model``) holds in int8 exactly the
    tensors ``jax_tree`` (the same weights through ``quantize_tree``) holds
    in int8, with the same ``q8`` marks, int8 values and scales, bit for bit.
    ``convert`` is the port's converter of the JAX tree
    (``from_jax_params``, ``from_jax_dit_params``): fed views of the tree
    (each int8 leaf as its values, its scales broadcast, or its mark), it
    puts them in the port's names and layouts. Returns the count of each
    form."""
    from vdpp_tpu.ops.quant import _qtensor

    from vdpp_tpu_torch.ops import quant as tq

    marks = convert(_int8_view(jax_tree, lambda d: np.full(np.shape(_qtensor(d)),
                                                      2.0 if "q8" in d else 1.0, np.float32),
                               np.zeros_like))
    qs = convert(_int8_view(jax_tree, lambda d: np.asarray(_qtensor(d), np.float32), lambda a: a))
    scales = convert(_int8_view(jax_tree, lambda d: np.broadcast_to(
        np.asarray(d["scale"]), np.shape(_qtensor(d))).astype(np.float32), lambda a: a))
    modules = dict(port.named_modules())
    forms = {"q": 0, "q8": 0}
    for name, mark in marks.items():
        prefix, _, leaf = name.rpartition(".")
        m = modules[prefix]
        want = {0.0: None, 1.0: "q", 2.0: "q8"}[float(mark.reshape(-1)[0])]
        assert tq.int8_forms(m).get(leaf) == want, name
        if want is None:
            continue
        forms[want] += 1
        q, scale = tq.int8_tensor(m, leaf), getattr(m, leaf + "_scale")
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        assert torch.equal(q.float(), qs[name]), name
        assert torch.equal(scale.expand(q.shape), scales[name]), name
    return forms


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tests: their CPU tensors are
    small, and beside the suite's other parallel workers more threads only
    spin (measured here: 4x the CPU seconds for the same tests)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- step-pipeline jobs: each rank of a spawned group imports this module
# ---- (no JAX here, so that the ranks start quickly) and runs one of these.


def dummy_build(model_kw: dict, state: dict, device):
    """``(step_fn, params)`` of a DummyUNet holding ``state``."""
    from vdpp_tpu_torch.models.dummy_unet import DummyUNet

    model = DummyUNet(**model_kw, device=device)
    model.load_state_dict(state)
    return (lambda p, x, k: p(x, k)), model


def svd_build(config, solver: str, num_steps: int, pad_steps_to, state: dict, cond, device,
              axes: dict | None = None, **wrapper_kw):
    """``(step_fn, params)`` of the SVD wrapper's step over an SVDUNet
    holding ``state``, with the conditioning ``cond`` (CPU tensors), over
    ``axes`` (a Stage's ``axes``: its seq, frame and cfg axes) when given;
    ``wrapper_kw`` goes to the wrapper (DeepCache, CFG mode, noise)."""
    import dataclasses

    from vdpp_tpu_torch.models.svd_unet import SVDUNet
    from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet
    from vdpp_tpu_torch.ops.quant import load_int8_forms

    if torch.device(device).type == "cuda":  # the same bits in every process
        torch.backends.cudnn.deterministic = True
    wrapper = StableVideoUNet(config, num_steps=num_steps, pad_steps_to=pad_steps_to,
                              solver=solver, device=device, **wrapper_kw)
    unet = SVDUNet(config, device=device)
    load_int8_forms(unet, state)  # a quantized state holds int8 tensors
    unet.load_state_dict(state)
    cond = dataclasses.replace(cond, **{f.name: getattr(cond, f.name).to(device)
                                        for f in dataclasses.fields(cond)
                                        if getattr(cond, f.name) is not None})
    return wrapper.pipeline_step_fn(**(axes or {})), (unet, cond)


def dit_build(config, num_steps: int, state: dict, context, guidance, device,
              axes: dict | None = None, **wrapper_kw):
    """``(step_fn, params)`` of the DiT wrapper's step over a DiTVideo
    holding ``state``, with ``context`` (a tensor, a ``(neg, pos)`` tuple or
    None) and ``guidance`` (or None), CPU tensors, over ``axes`` (a Stage's
    ``axes``) when given."""
    wrapper, params = dit_runner_build(config, num_steps, state, context, guidance, device,
                                       **wrapper_kw)
    return wrapper.pipeline_step_fn(**(axes or {})), params


def dit_runner_build(config, num_steps: int, state: dict, context, guidance, device,
                     **wrapper_kw):
    """``(wrapper, (dit, context, guidance))`` as :func:`dit_build` builds
    them, for a runner that takes the wrapper."""
    from vdpp_tpu_torch.models.dit import DiTVideo, DiTVideoWrapper
    from vdpp_tpu_torch.ops.quant import load_int8_forms

    def to(t):
        if isinstance(t, tuple):
            return tuple(to(x) for x in t)
        return None if t is None else t.to(device)

    wrapper = DiTVideoWrapper(config, num_steps=num_steps, device=device, **wrapper_kw)
    dit = DiTVideo(config, device=device)
    load_int8_forms(dit, state)
    dit.load_state_dict(state)
    return wrapper, (dit, to(context), to(guidance))


class NoiseTable:
    """A wrapper's ``noise_source``: the draw for step k is ``table[k]``
    (numpy arrays, so that it pickles into spawned ranks)."""

    def __init__(self, table: dict):
        self.table = table

    def __call__(self, step: int, shape) -> torch.Tensor:
        z = torch.tensor(self.table[step])
        assert tuple(z.shape) == tuple(shape), (z.shape, shape)
        return z


def pipeline_cases(stage, cases: list) -> dict:
    """Rank job: every ``(name, build, inputs, total_steps, ticked)`` case
    through a ``StepPipeline`` over all of the group's ranks, where
    ``build(device)`` gives ``(step_fn, params)``. Returns, on the last rank,
    ``{name: outputs}`` (ticked: ``(outputs, tick count, [(i, latent) seen by
    on_sample])``), and on the others ``{name: None}``."""
    from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline

    results = {}
    for name, build, inputs, total, ticked in cases:
        step_fn, params = build(stage.device)
        pipe = StepPipeline(stage, step_fn, PipelineConfig(total, stage.num_stages))
        if not ticked:
            results[name] = pipe.run(params, inputs)
            continue
        seen = []
        res = pipe.run_ticked(params, inputs, on_sample=lambda i, x: seen.append((i, x.clone())))
        results[name] = None if res is None else (res[0], len(res[1]), seen)
    return results


def rank_skewed_step(model, x, step):
    """A simulator model call that differs on rank 1 of a process group (and
    nowhere else): the simulator must catch it."""
    import torch.distributed as dist

    out = model(x, step)
    if dist.is_initialized() and dist.get_rank() == 1:
        out = out + 1e-3
    return out


def runner_cases(stage, cases: list) -> dict:
    """Rank job: every ``(name, kind, build, inputs, total_steps)`` case on the
    group's mesh, where ``build(device)`` gives ``(step_fn, params)`` and
    ``kind`` is ``"dp"`` (``DataParallelRunner``: this rank's block),
    ``"fsdp"`` (``FSDPRunner`` sharding every tensor it can: ``(outputs,
    parameter bytes this rank holds, names of gathered tensors still held
    after the run)``), ``"pipeline"`` (``StepPipeline.run``: a column's
    outputs on its last stage, else None) or ``"ticked"``
    (``StepPipeline.run_ticked``: ``(outputs, tick seconds)`` or None)."""
    from vdpp_tpu_torch.parallel.data_parallel import DataParallelRunner, FSDPRunner
    from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline
    from vdpp_tpu_torch.utils.memory import bundle_modules, params_bytes_per_device

    results = {}
    for name, kind, build, inputs, total in cases:
        step_fn, params = build(stage.device)
        if kind == "dp":
            results[name] = DataParallelRunner(stage, step_fn, total).run(params, inputs)
        elif kind == "fsdp":
            out = FSDPRunner(stage, step_fn, total, min_shard_params=0).run(params, inputs)
            held = [n for m in bundle_modules(params) for sub in m.modules()
                    for n in sub.__dict__.get("_fsdp_dims", {}) if n in sub.__dict__]
            results[name] = (out, params_bytes_per_device(params), held)
        else:
            pipe = StepPipeline(stage, step_fn, PipelineConfig(total, stage.num_stages))
            results[name] = (pipe.run(params, inputs) if kind == "pipeline"
                             else pipe.run_ticked(params, inputs))
    return results


def resume_cases(stage, cases: list) -> dict:
    """Rank job: every ``(name, build, inputs, total_steps, kw)`` case through
    ``StepPipeline.run_ticked(params, inputs, **kw)``, where ``build(device)``
    gives ``(step_fn, params)``. Besides ``run_ticked``'s own arguments ``kw``
    may hold ``gather`` (keep every buffer ``on_tick`` gets), ``snap_path``
    (also write each one to ``snap_path % t`` with ``save_pipeline_state``)
    and ``resume_path`` (start after that snapshot's tick, from its buffer;
    every rank reads it). Returns on the last rank ``{name: (outputs, tick
    count, [(t, buf)])}``, on the others ``{name: None}``."""
    from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline
    from vdpp_tpu_torch.utils.resume import load_pipeline_state, save_pipeline_state

    results = {}
    for name, build, inputs, total, kw in cases:
        kw = dict(kw)
        step_fn, params = build(stage.device)
        pipe = StepPipeline(stage, step_fn, PipelineConfig(total, stage.num_stages))
        seen = []
        snap_path = kw.pop("snap_path", None)
        resume_path = kw.pop("resume_path", None)
        if resume_path is not None:
            tick, buf, _ = load_pipeline_state(resume_path)
            kw.update(start_tick=tick + 1, initial_buf=buf)
        if kw.pop("gather", False) or snap_path is not None:
            def on_tick(t, buf, name=name, snap_path=snap_path, seen=seen):
                seen.append((t, buf.clone()))
                if snap_path is not None:
                    save_pipeline_state(snap_path % t, t, buf, meta={"case": name})
            kw["on_tick"] = on_tick
        res = pipe.run_ticked(params, inputs, **kw)
        results[name] = None if res is None else (res[0], len(res[1]), seen)
    return results


# ---- intra-sample axes (tests/test_torch_port_{seq,frame,cfg}_parallel.py) ---- #


def relayout(stage, **axes):
    """This rank's Stage of another layout of the same group: ``axes`` gives
    ``seq``, ``frame``, ``cfg`` and ``expert`` (the rest 1; the stage count
    follows). All the group's ranks call it alike, so they create the same
    subgroups."""
    import dataclasses

    from vdpp_tpu_torch.parallel.mesh import Stage

    mesh = dataclasses.replace(stage.mesh,
                               **{"seq": 1, "frame": 1, "cfg": 1, "expert": 1, **axes})
    return Stage(mesh, stage.rank)


def _shard(x, axis, dim: int):
    """This rank's contiguous block of ``x`` along ``dim``."""
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n)


def _op_case(stage, op: str, x, state: dict, kw: dict):
    """One sharded op on this rank's block of ``x`` (the whole input, the
    same on every rank), gathered whole again: ``conv2d_halo`` (W split over
    seq), ``conv2d_rows`` (rows split over frame, the W8A8 scale taken over
    it), ``conv_temporal_halo`` (frames over frame), ``group_norm`` (W over
    seq), ``attention`` (tokens over seq), ``temporal_self_attention``
    (frames over frame; ``env`` set around it) and ``moe`` (the experts over
    expert: ``moe_ff``, or ``moe_ff_gather`` at ``kw["capacity"]``; the
    tokens whole on every rank). Modules are built from ``state``, in the
    int8 form where it holds one."""
    import os

    from vdpp_tpu_torch.ops import attention as tattn
    from vdpp_tpu_torch.ops import conv as tconv
    from vdpp_tpu_torch.ops import moe as tmoe
    from vdpp_tpu_torch.ops import normalization as tnorm
    from vdpp_tpu_torch.ops.quant import load_int8_forms
    from vdpp_tpu_torch.parallel.collectives import all_gather

    def module(cls, *args):
        m = cls(*args)
        load_int8_forms(m, state)
        m.load_state_dict(state)
        return m

    seq, frame = stage.seq, stage.frame
    if op == "conv2d_halo":
        conv = module(tconv.Conv2d, x.shape[-1], kw["out"], 3)
        return all_gather(tconv.conv2d_halo(_shard(x, seq, 2), conv, seq, stride=kw["stride"]),
                          seq, 2)
    if op == "conv2d_rows":
        conv = module(tconv.Conv2d, x.shape[-1], kw["out"], 3)
        return all_gather(tconv.conv2d(_shard(x, frame, 0), conv, amax_axes=(frame,)), frame, 0)
    if op == "moe":
        moe = module(tmoe.MoEFF, x.shape[-1], kw["experts"], kw["inner"])
        tmoe.shard_experts(moe, stage.expert)
        if kw.get("capacity") is None:
            return tmoe.moe_ff(moe, x, stage.expert)
        return tmoe.moe_ff_gather(moe, x, stage.expert, capacity_factor=kw["capacity"])
    if op == "conv_temporal_halo":
        conv = module(tconv.ConvTemporal, x.shape[-1], kw["out"], 3)
        return all_gather(tconv.conv_temporal_halo(_shard(x, frame, 1), conv, frame), frame, 1)
    if op == "group_norm":
        norm = module(tnorm.Norm, x.shape[-1])
        return all_gather(tnorm.group_norm(_shard(x, seq, 2), norm, kw["groups"],
                                           psum_axis=seq), seq, 2)
    if op == "attention":
        attn = module(tattn.Attention, x.shape[-1])
        return all_gather(tattn.attention(_shard(x, seq, 1), attn, kw["heads"], seq_axis=seq),
                          seq, 1)
    if op == "temporal_self_attention":
        attn = module(tattn.Attention, x.shape[-1])
        b, f = kw["batch"], kw["frames"]
        xl = _shard(x.reshape(b, f, *x.shape[1:]), frame, 1).reshape(-1, *x.shape[1:])
        saved = {k: os.environ.get(k) for k in kw.get("env", {})}
        os.environ.update(kw.get("env", {}))
        before = tattn.frame_axis_fallbacks
        try:
            out = tattn.temporal_self_attention(attn, xl, kw["heads"], b, f // frame.size,
                                                frame_axis=frame)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        out = all_gather(out.reshape(b, f // frame.size, *x.shape[1:]), frame, 1)
        return out.reshape(x.shape), tattn.frame_axis_fallbacks - before
    raise ValueError(op)


def intra_cases(stage, cases: list) -> dict:
    """Rank job: each ``(name, layout, kind, args)`` on this group laid out
    as ``layout`` (:func:`relayout`). ``kind`` is ``"op"`` (``args``:
    :func:`_op_case`'s), ``"pipeline"`` (``args``: ``(build, inputs,
    total_steps)``, ``build(device, axes)`` giving ``(step_fn, params)``,
    through ``StepPipeline.run``), ``"cfg_runner"`` (the same through
    ``CFGParallelRunner``, one sample at a time) or ``"seq_runner"``
    (``args``: ``(build, inputs)``, ``build(device)`` giving ``(wrapper,
    (dit, context, guidance))``, through ``SequenceParallelRunner``, one
    sample at a time). A model case's result is ``(outputs, the collectives'
    call counts)``; a pipeline on a mesh with an expert axis lays its
    experts out (``ops.moe.expert_layout``) and adds the parameter bytes the
    last rank holds. Returns every case's result on the mesh's last rank and
    ``{name: None}`` on the others."""
    from vdpp_tpu_torch.ops.moe import expert_layout
    from vdpp_tpu_torch.parallel import collectives
    from vdpp_tpu_torch.parallel.cfg_parallel import CFGParallelRunner
    from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline
    from vdpp_tpu_torch.parallel.sequence_parallel import SequenceParallelRunner
    from vdpp_tpu_torch.utils.memory import params_bytes_per_device

    results = {}
    for name, layout, kind, args in cases:
        st = relayout(stage, **layout)
        collectives.clear_counts()
        with torch.inference_mode():
            if kind == "op":
                out = _op_case(st, *args)
            elif kind == "seq_runner":
                build, inputs = args
                wrapper, (params, ctx, guidance) = build(st.device)
                runner = SequenceParallelRunner(st, wrapper)
                out = (torch.stack([runner.run(params, x, ctx, guidance) for x in inputs]),
                       dict(collectives.counts))
            else:
                build, inputs, total = args
                step_fn, params = build(st.device, st.axes)
                if kind == "pipeline":
                    spec = expert_layout if st.expert is not None else None
                    pipe = StepPipeline(st, step_fn, PipelineConfig(total, st.num_stages),
                                        param_spec=spec)
                    out = (pipe.run(params, inputs), dict(collectives.counts))
                    if spec is not None:
                        out += (params_bytes_per_device(params),)
                else:
                    runner = CFGParallelRunner(st, step_fn, total)
                    out = (torch.stack([runner.run(params, x) for x in inputs]),
                           dict(collectives.counts))
        results[name] = out
    return results if stage.is_last_rank else dict.fromkeys(results)


# ---- the chunk-parallel VAE decode (tests/test_torch_port_decode_parallel.py) ---- #


def decode_cases(stage, state: dict, cases: list) -> dict:
    """Rank job on a mesh with decode ranks: a tiny VAE decoder holding
    ``state`` decodes each ``(name, latents, chunk_frames, over)`` with
    ``decode_data_parallel`` over ``over``: ``"decode"`` (the decode ranks,
    gathered to the first of them; the stage ranks sit it out) or ``"all"``
    (every rank, gathered to rank 0). Returns ``{name: video}`` from each
    case's root, None elsewhere."""
    from vdpp_tpu_torch.models.vae import TemporalVAEDecoder, VAEConfig

    dec = TemporalVAEDecoder(VAEConfig.tiny(), device=stage.device)
    dec.load_state_dict(state)
    results = {}
    for name, latents, chunk, over in cases:
        axis = stage.decode_axis if over == "decode" else stage.ranks_axis()
        if over == "decode" and not stage.is_decode:
            results[name] = None
            continue
        results[name] = dec.decode_data_parallel(latents, axis, chunk)
    return results


# ---- streaming jobs (tests/test_torch_port_stream.py) ---- #


def dummy_step(model, x, step):
    """A module-level step function (it pickles into spawned ranks)."""
    return model(x, step)


def stream_dummy_job(stage, model_kw: dict, state: dict, total_steps: int):
    """``StreamJob`` of a DummyUNet holding ``state``. A stream's payload None
    steps the model; a payload ``("fail", r)`` makes the step raise
    ("injected tick failure") on rank r alone."""
    from vdpp_tpu_torch.parallel.pipeline import StreamJob

    model = dummy_build(model_kw, state, stage.device)[1]

    def step(params, x, k):
        if isinstance(params, tuple):
            if stage.rank == params[1]:
                raise RuntimeError("injected tick failure")
            params = model
        return params(x, k)

    return StreamJob(step, total_steps, bundle=lambda payload: model if payload is None
                     else payload)


def hold_stream_ranks(stages: int = 2) -> None:
    """Main of a server stand-in: start a stream group of ``stages`` CPU
    ranks, print ``PIDS <rank pids>``, and wait to be killed."""
    import time

    from vdpp_tpu_torch.models.dummy_unet import DummyUNet
    from vdpp_tpu_torch.parallel.mesh import make_pipeline_mesh
    from vdpp_tpu_torch.parallel.pipeline import StreamRanks

    kw = dict(channels=4, hidden_channels=8)
    state = DummyUNet(**kw, device="cpu").init_weights(torch.Generator().manual_seed(0))
    ranks = StreamRanks(make_pipeline_mesh(stages, device="cpu"), stream_dummy_job, kw,
                        state.state_dict(), stages, threads=1)
    print("PIDS", *ranks.pids, flush=True)
    time.sleep(600)
