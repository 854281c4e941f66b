"""LM training cells: the port's LM training step
(``repro_torch.launch.train.build_trainer``: ``models/lm.py::loss_fn``,
autograd, PowerSync over one shard, AdamW) on a configuration given by
its published keys (``portbench/configs/<config>.json``), fed one batch
after another from a pool made in set-up and kept on the device.

Set-up builds the model from the seed and the pool of batches
(``data/lm_data.batch_at`` over the configuration's vocabulary), and
drives the first ``checked_steps`` steps through the window's own call,
under a host-only profiler so that the program's record (``obs``) counts
what each dropped.  For each it keeps on the host the params it started
from, its loss and the gradients ``loss_fn`` gave (before PowerSync), and
checks PowerSync's synced gradients and new residual at once against a
plain PowerSync on the same gradients and residual.  The window then runs
step after step until ``seconds`` have passed, each ended by its host read
of the loss; its peak memory is read at its end.  The step after it is
checked too, recorded as the set-up steps are (outside the window: the
profiler costs some 90-240 ms a step on the card's host), from the params
and optimizer state the window left: as the set-up steps are, and besides
its AdamW update (new params, f32 master and moments) against a plain
AdamW on its synced gradients, checked at once on the card.  After that
the program's state is freed and the plain reference
(``portbench/reference/lm.py``) computes each checked step's loss and
gradients on the device in float32, TF32 off, a sequence at a time.
``dropped`` is the program's own count over the steps its record saw: the
set-up steps, the step after the window and, traced, the traced slice.

Gradients are compared leaf by leaf, a stacked leaf split into its layers
and an expert leaf into its experts (the L2 gap of a part over its own
reference norm or, for an expert, over the RMS of its layer's experts'
norms, at least a tenth of the leaf's RMS over its layers), so one expert
gone wrong is not averaged away, and an expert routed almost nothing, or
a layer whose gradient has all but vanished, does not read as one.  The set-up steps are
compared with the reference routing each token by its own top k
(``grad_gap``).  The step after the window, some 45 steps into
training, is compared with the reference sending each token to the
experts the program chose (``close_grad_gap``), and the choices that
differ are counted apart (``route_flips``): a choice flipped by bfloat16
rounding moves an expert's gradient by that token's whole part, and over
the first steps that reads up to 10x the rest of the gap.  Some of that
step's attention and embedding gradients part from float32 by more than
the first steps' do (PERF.md), so its limit is its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from portbench import check, lm_work, seeds, trace
from portbench.reference import lm as ref

# names of the program's regions whose device time the readers take
REGIONS = ("lm.mla.attend", "lm.moe.route", "lm.moe.experts",
           "lm.moe.combine")
# published keys the port's DeepSeek-V2 layers cannot express otherwise
FIXED = {"q_lora_rank": None, "scoring_func": "softmax",
         "topk_method": "greedy", "routed_scaling_factor": 1,
         "hidden_act": "silu", "moe_layer_freq": 1, "n_group": 1,
         "topk_group": 1, "tie_word_embeddings": False,
         "attention_bias": False}


def arch_config(c: dict):
    """The port's ``ArchConfig`` for configuration ``c``: the registered
    ``c["port_arch"]`` with the published keys, this card's layers,
    experts and vocabulary, YaRN and the dropless layer.  Raises when the
    program has no such settings (a version before them)."""
    from repro_torch import configs
    from repro_torch.configs.base import MLASpec, MoESpec

    for k, v in FIXED.items():
        if c[k] != v:
            raise ValueError(f"{k}={c[k]!r}: the port's layers take {v!r}")
    missing = [f for f in ("experts_held", "norm_topk_prob", "dropless")
               if f not in {x.name for x in dataclasses.fields(MoESpec)}]
    if missing or not hasattr(configs, "YaRNSpec"):
        raise RuntimeError("this version of the program has no dropless "
                           "MoE layer over held experts and no YaRN")
    y = c["rope_scaling"]
    if y.get("type") != "yarn":
        raise ValueError(f"rope_scaling type {y.get('type')!r}")
    base = configs.get_config(c["port_arch"])
    moe = dataclasses.replace(
        base.moe, num_experts=c["n_routed_experts"],
        top_k=c["num_experts_per_tok"], d_expert=c["moe_intermediate_size"],
        num_shared=c["n_shared_experts"], experts_held=c["experts_held"],
        norm_topk_prob=c["norm_topk_prob"], dropless=bool(c["dropless"]))
    return dataclasses.replace(
        base, vocab_size=c["vocab_size"], d_model=c["hidden_size"],
        n_layers=c["n_layers"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        rope_theta=float(c["rope_theta"]),
        mla=MLASpec(kv_lora=c["kv_lora_rank"], qk_nope=c["qk_nope_head_dim"],
                    qk_rope=c["qk_rope_head_dim"], v_head=c["v_head_dim"]),
        moe=moe, dense_first_n=c["first_k_dense_replace"],
        rope_scaling=configs.YaRNSpec(
            factor=float(y["factor"]), mscale=float(y["mscale"]),
            mscale_all_dim=float(y["mscale_all_dim"]),
            beta_fast=float(y["beta_fast"]), beta_slow=float(y["beta_slow"]),
            original_max_position=int(y["original_max_position_embeddings"])),
        norm_eps=float(c["rms_norm_eps"]))


def ref_config(c: dict) -> dict:
    """The configuration as the reference reads it: the published keys,
    this card's layers in ``num_hidden_layers``."""
    return dict(c, num_hidden_layers=c["n_layers"])


def shape(cfg, tr: dict) -> dict:
    """What ``lm_work`` counts from (``lm_work.Shape``'s fields)."""
    m, e = cfg.mla, cfg.moe
    n_moe = cfg.n_layers - cfg.dense_first_n
    return dict(batch=tr["batch"], seq=tr["seq"], d_model=cfg.d_model,
                n_heads=cfg.n_heads, qk_nope=m.qk_nope, qk_rope=m.qk_rope,
                v_head=m.v_head, kv_lora=m.kv_lora, d_ff=cfg.d_ff,
                d_expert=e.d_expert, n_experts=e.num_experts,
                n_shared=e.num_shared, vocab=cfg.vocab_size,
                n_dense=cfg.dense_first_n, n_moe=n_moe, n_remat=n_moe)


class Capture:
    """Keeps the inputs and outputs of the program's PowerSync call
    (``launch.train.powersync_tree``) while it is `on`: the gradients that
    ``loss_fn`` gave, the residual before, the synced gradients and the
    new residual (references, no copies)."""

    def __init__(self):
        from repro_torch.launch import train as lm_train
        self._mod = lm_train
        self._real = lm_train.powersync_tree
        self.got = None

    @contextlib.contextmanager
    def on(self):
        def kept(grads, residual, *a, **kw):
            synced, new_res = self._real(grads, residual, *a, **kw)
            self.got = (grads, residual, synced, new_res)
            return synced, new_res
        self._mod.powersync_tree = kept
        try:
            yield self
        finally:
            self._mod.powersync_tree = self._real

    def take(self):
        got, self.got = self.got, None
        if got is None:
            raise RuntimeError("the step made no PowerSync call")
        return got


class Routes:
    """Keeps the experts the program's MoE layers chose (``models.moe.
    top_k``'s indices [B, S, k]) in the forward of a step while it is
    `on`: the first call of each layer (remat's run again comes after)."""

    def __init__(self, n_layers: int):
        from repro_torch.models import moe
        self._mod, self._real, self.n = moe, moe.top_k, n_layers
        self.got = []

    @contextlib.contextmanager
    def on(self):
        def kept(x, k):
            v, i = self._real(x, k)
            if len(self.got) < self.n:
                self.got.append(i.detach())
            return v, i
        self.got = []
        self._mod.top_k = kept
        try:
            yield self
        finally:
            self._mod.top_k = self._real

    def take(self) -> list:
        got, self.got = self.got, []
        if len(got) != self.n:
            raise RuntimeError(f"{len(got)} routings kept, {self.n} MoE "
                               f"layers")
        return got


def _host(tree) -> dict:
    return {p: t.detach().cpu() for p, t in ref.leaves(tree).items()}


def sync_numbers(got, pscfg) -> float:
    """PowerSync's synced gradients and new residual against the plain
    PowerSync on the same gradients and residual: the largest |gap| over
    the largest |plain value|, over both and every leaf (0 when they are
    equal, the selected rows and columns with them)."""
    grads, res_in, synced, res_out = (ref.leaves(t) for t in got)
    want_s, want_r = ref.powersync(grads, res_in, pscfg.lambda_rows,
                                   pscfg.lambda_cols, pscfg.min_dense_size)
    worst = 0.0
    for p in grads:
        for have, want in ((synced[p], want_s[p]), (res_out[p], want_r[p])):
            gap = float((have.float() - want.float()).abs().max())
            top = float(want.float().abs().max())
            worst = max(worst, gap / top if top > 0 else gap)
    return worst


def _groups(path, t: torch.Tensor):
    """A leaf's parts as compared, in groups that share a scale: a stacked
    leaf by layer, an expert leaf (``stack/moe/wi|wg|wo``) by layer and,
    within a layer, by expert."""
    if path[0] != "stack":
        return [[t]]
    if len(path) == 3 and path[1] == "moe" and path[2] in ("wi", "wg", "wo"):
        return [list(layer.unbind(0)) for layer in t.unbind(0)]
    return [[layer] for layer in t.unbind(0)]


# a group's scale is at least this share of its leaf's (the RMS of its
# groups' scales): a layer whose gradient has all but vanished (some 45
# steps in, one MoE layer's experts can read 1e-10 beside the others'
# 1e-3) is not compared by its own rounding
FLOOR = 0.1


def grad_gap(have: dict, want: dict, device) -> float:
    """The worst gap over the compared parts of the leaves: a part's L2
    gap over the RMS of its group's reference norms (its own norm, for a
    part alone in its group; for an expert, the norm an expert of its
    layer has on average, so an expert that was routed almost nothing
    does not turn rounding into a large ratio), or over `FLOOR` times the
    RMS of the leaf's group scales where that is larger."""
    worst = 0.0
    for p, w in want.items():
        h = have[p].to(device).float()
        groups = list(zip(_groups(p, h), _groups(p, w)))
        scales = [(sum(float(x.norm()) ** 2 for x in ws) / len(ws)) ** 0.5
                  for _, ws in groups]
        floor = FLOOR * (sum(x * x for x in scales) / len(scales)) ** 0.5
        for (hs, ws), scale in zip(groups, scales):
            scale = max(scale, floor)
            for hp, wp in zip(hs, ws):
                num = float((hp - wp).norm())
                worst = max(worst, num / scale if scale > 0 else num)
    return worst


def flips(own: list, routes: list) -> float:
    """The largest share, over the MoE layers, of tokens whose set of
    chosen experts differs between ``own`` and ``routes``."""
    worst = 0.0
    for a, b in zip(own, routes):
        a = a.reshape(-1, a.shape[-1]).sort(-1).values
        b = b.to(a.device).reshape(a.shape).long().sort(-1).values
        worst = max(worst, float((a != b).any(-1).float().mean()))
    return worst


def adamw_numbers(start_opt, new_params, new_opt, synced, tr: dict,
                  control: bool = False) -> float:
    """The checked step's AdamW update against the plain one
    (``reference.lm.adamw``) on the same synced gradients and starting
    state, leaf by leaf on the device: the L2 gap of the new f32 master and
    of the new bf16 params (against the plain master rounded to bf16) over
    the L2 norm of the plain update, and of each new moment over its plain
    norm; the worst of them.  With ``control`` the plain update kept in
    bfloat16 (master and moments) stands in the program's place."""
    have = {n: ref.leaves(t) for n, t in
            (("params", new_params), ("master", new_opt.master),
             ("m", new_opt.m), ("v", new_opt.v))}
    keys = ("lr", "warmup_steps", "b1", "b2", "eps", "weight_decay",
            "grad_clip")
    old = ref.leaves(start_opt.master)
    worst = 0.0

    def gap(h, w, norm):
        num = float((h.float() - w).norm())
        return num / norm if norm > 0 else num
    for path, w1, m1, v1 in ref.adamw(
            ref.leaves(synced), old, ref.leaves(start_opt.m),
            ref.leaves(start_opt.v),
            int(start_opt.step) + 1,
            **{k: tr[k] for k in keys}):
        step_norm = float((w1 - old[path]).norm())
        if control:
            h = {n: t.to(torch.bfloat16) for n, t in
                 (("master", w1), ("m", m1), ("v", v1), ("params", w1))}
        else:
            h = {n: have[n][path] for n in have}
        worst = max(worst, gap(h["master"], w1, step_norm),
                    gap(h["params"], w1.to(torch.bfloat16).float(),
                        step_norm),
                    gap(h["m"], m1, float(m1.norm())),
                    gap(h["v"], v1, float(v1.norm())))
    return worst


def step_numbers(kept: dict, batch: dict, c: dict, device,
                 precision: str = "float32", want=None) -> dict:
    """The check's numbers of one kept step against the reference: a
    set-up step with the reference routing by its own top k, the step
    after the window (``kept["routes"]``) with it routing as the program
    did; with ``want`` (the float32 reference's (loss, grads, own
    routing)) the reference at ``precision`` stands in the program's
    place (the control)."""
    params = {p: t.to(device) for p, t in kept["params"].items()}
    tree = ref._unflatten(kept["tree"], params)
    routes = kept.get("routes")
    own = [] if routes is not None else None
    loss, grads = ref.loss_and_grads(tree, batch["tokens"], batch["labels"],
                                     c, precision=precision, routes=routes,
                                     own=own)
    if want is not None:
        have_loss, have_grads, have_own = loss, grads, own
        loss, grads, own = want
        chosen = have_own
    else:
        have_loss, have_grads = kept["loss"], kept["grads"]
        chosen = routes
    gap = grad_gap(have_grads, grads, device)
    closing = routes is not None
    return {"loss_gap": abs(have_loss - loss) / abs(loss),
            "grad_gap": 0.0 if closing else gap,
            "close_grad_gap": gap if closing else 0.0,
            "route_flips": flips(own, chosen) if closing else 0.0,
            "sync_gap": kept["sync_gap"],
            "adamw_gap": kept.get("adamw_control" if want is not None
                                  else "adamw_gap", 0.0),
            "dropped": kept.get("dropped", 0)}, (loss, grads, own)


def _structure(tree):
    """The tree's containers with its leaves dropped (for rebuilding)."""
    return ref._map(lambda t: None, tree)


def worst(steps: list) -> dict:
    out = {k: max(s[k] for s in steps) for k in steps[0]}
    out["dropped"] = sum(s["dropped"] for s in steps)
    return out


def _region_seconds(events) -> dict:
    """Device seconds of the operations under each of `REGIONS` (their
    host-side ranges' device totals, the forward's and the backward's
    runs of the forward alike)."""
    from torch.autograd import DeviceType

    out = {n: 0.0 for n in REGIONS}
    for e in events:
        if e.name in out and e.device_type == DeviceType.CPU:
            out[e.name] += e.device_time_total / 1e6
    return out


def _device_reading(tracer: trace.Tracer):
    """The traced slice's busy time, operations and idle gaps (the
    regions' device-side annotations are not device work), and the
    regions' device seconds."""
    from torch.autograd import DeviceType

    events = tracer.prof.events()
    ops = [e for e in events if not (e.device_type == DeviceType.CUDA
                                     and e.name in REGIONS)]
    reading = trace.read_events(ops, tracer.t1 - tracer.t0)
    reading["regions"] = _region_seconds(events)
    return reading


def _notes(phases: dict, steps: list, window_s: float) -> list:
    ms = sorted(1e3 * s["wall_s"] for s in steps)
    mid = len(ms) // 2
    return ["set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                  phases.items()),
            f"window {window_s:.3f} s, {len(steps)} steps; min / median / "
            f"max ms a step {ms[0]:.1f} / {ms[mid]:.1f} / {ms[-1]:.1f}"]


def run(spec: dict, *, seed: int, seconds: float, trace_on: bool, device,
        t_start: float, program=None, control=None) -> dict:
    """One run of an LM training cell; ``program`` injects the trainer
    maker (``build_trainer``'s signature: tests break it underneath);
    ``control`` (a precision of ``reference.lm.Precision``) also reads the
    control: the reference at that precision in the program's place."""
    c, tr, par = spec["config"], spec["traffic"], spec["params"]
    cfg = arch_config(c)
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.data.lm_data import batch_at
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.powersync import PowerSyncConfig, residual_init

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    phases = {}
    t_last = t_start

    def mark(name: str) -> None:
        nonlocal t_last
        if cuda:
            torch.cuda.synchronize(dev)
        t_now = time.time()
        phases[name] = t_now - t_last
        t_last = t_now

    if cuda:
        torch.empty(1, device=dev)
    elif lm_work.token_params(lm_work.as_shape(shape(cfg, tr))) > 50e6:
        raise ValueError("a full-width LM cell runs on the card; the CPU "
                         "takes a cut copy of its spec")
    mark("start_imports_context")
    acfg = AdamWConfig(**{k: tr[k] for k in (
        "lr", "warmup_steps", "b1", "b2", "eps", "weight_decay",
        "grad_clip")})
    pscfg = PowerSyncConfig(lambda_rows=tr["lambda_rows"],
                            lambda_cols=tr["lambda_cols"])
    step, _meter, mod = (program or build_trainer)(cfg, acfg, pscfg, 1,
                                                   tr["sync"], dev)
    params = mod.init(cfg, seed=seeds.derive(seed, "init"), device=dev)
    tree = _structure(params)
    opt = adamw_init(params)
    residual = residual_init(params)
    mark("model")
    data_seed = seeds.derive(seed, "data")
    pool = [batch_at(data_seed, i, tr["batch"], tr["seq"], cfg.vocab_size,
                     device=dev) for i in range(int(tr["pool_batches"]))]
    mark("batches")

    capture = Capture()
    routes = Routes(cfg.n_layers - cfg.dense_first_n)
    n_check = int(par["checked_steps"])
    kept = []
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(n_check):
            start = _host(params)
            with capture.on():
                loss, params, opt, residual = step(params, opt, residual,
                                                   pool[i % len(pool)])
                loss = float(loss)
            got = capture.take()
            counters = obs.steps()[-1].counters
            kept.append(dict(tree=tree, params=start, batch=i % len(pool),
                             loss=loss, grads=_host(got[0]),
                             sync_gap=sync_numbers(got, pscfg),
                             dropped=int(counters.get("dropped", 0))))
            del got
            if i == 0:
                mark("first_step")
    mark("checked_steps")
    setup_s = t_last - t_start
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    peak = [0]

    def run_steps(first: int, seconds: float, spans: bool):
        """Steps one after another until ``seconds`` have passed, each
        ended by its host read of the loss."""
        nonlocal params, opt, residual
        out = []
        t0 = t_prev = time.time()
        i = first
        while True:
            b = i % len(pool)
            with trace.span("pb.lm.step", spans):
                loss, params, opt, residual = step(params, opt, residual,
                                                   pool[b])
                loss = float(loss)
            t_now = time.time()
            out.append(dict(wall_s=t_now - t_prev,
                            tokens=tr["batch"] * tr["seq"], batch=b))
            t_prev = t_now
            i += 1
            if t_now - t0 >= seconds:
                return out

    def closing_step(i: int) -> dict:
        """Step ``i``, the one after the window, under a host-only profiler
        (so that the program's record counts it) with its PowerSync call
        and its routing kept: what its check needs, the params and AdamW
        state it started from too."""
        nonlocal params, opt, residual
        b = i % len(pool)
        start = (params, opt)
        with profile(activities=[ProfilerActivity.CPU]), capture.on(), \
                routes.on():
            loss, params, opt, residual = step(params, opt, residual,
                                               pool[b])
            loss = float(loss)
        counters = obs.steps()[-1].counters
        obs.clear()
        return dict(tree=tree, start=start, batch=b, loss=loss,
                    got=capture.take(), routes=routes.take(),
                    dropped=int(counters.get("dropped", 0)))

    steps = run_steps(n_check, seconds, False)
    window_s = sum(s["wall_s"] for s in steps)
    if cuda:
        peak[0] = torch.cuda.max_memory_allocated(dev)
    closing = closing_step(n_check + len(steps))
    got = closing.pop("got")
    closing["sync_gap"] = sync_numbers(got, pscfg)
    start_params, start_opt = closing.pop("start")
    closing["adamw_gap"] = adamw_numbers(start_opt, params, opt, got[2], tr)
    if control is not None:
        closing["adamw_control"] = adamw_numbers(start_opt, params, opt,
                                                 got[2], tr, control=True)
    closing["params"] = _host(start_params)
    closing["grads"] = _host(got[0])
    del got, start_params, start_opt
    if cuda:
        torch.cuda.empty_cache()
    tracer = trace.Tracer(trace_on, dev)
    traced, reading, counters = [], None, []
    if trace_on:
        with tracer:
            traced = run_steps(n_check + len(steps) + 1,
                               float(par["trace_seconds"]), True)
        reading = _device_reading(tracer)
        recorded = [s for s in obs.steps() if s.spans[0].name == "lm.step"]
        if len(recorded) == len(traced):
            counters = [s.counters for s in recorded]
    # and the traced slice's steps, which the record saw too
    closing["dropped"] += sum(int(n.get("dropped", 0)) for n in counters)
    del params, opt, residual, step, mod
    if cuda:
        torch.cuda.empty_cache()

    c = ref_config(spec["config"])
    numbers, control_numbers = [], []
    for k in kept + [closing]:
        got, want = step_numbers(k, pool[k["batch"]], c, dev)
        numbers.append(got)
        if control is not None:
            control_numbers.append(step_numbers(
                k, pool[k["batch"]], c, dev, precision=control,
                want=want)[0])
        del want
    result = check.verdict(worst(numbers), spec["limits"])
    if control is not None:
        result["control"] = worst(control_numbers)
    tokens = sum(s["tokens"] for s in steps)
    return dict(
        end_to_end={"train_tokens_per_s": tokens / window_s,
                    "peak_mem_gib": peak[0] / 2**30, "setup_s": setup_s},
        attempted=n_check + len(steps) + 1 + len(traced), failed=0,
        lm=dict(steps=steps, window_s=window_s, traced=traced,
                counters=counters, shape=shape(cfg, tr)),
        trace=reading,
        breakdown=reading["breakdown"] if reading else None,
        check=result, peak_bytes=peak[0],
        notes=_notes(phases, steps, window_s))
