"""The two kinds of cell: a training job and a closed-loop prefill pool.

Each ``run_*`` sets up the port from the seed, runs the measured window,
reads the device's peak, frees the port's state, and then decides
``correct`` against the plain reference (``reference/``), which works
everything out again from the seed.  A :class:`Run` carries what the
result line and the per-layer readers need.

Training: set-up builds one state (model and AdamW moments) and drives
it through the traffic's first ``checked_steps`` steps through the
window's own step function and feed; the window goes on with the same
state.  The reference trains the same weights on the same batches; the
numbers compared are each step's loss, each leaf's norm of the first
step's clipped gradient as the optimizer holds it (its first moment over
``1 - b1``) and of the change of the weights over the checked steps,
and the first gradient's difference on samples of every slice
(:func:`train_numbers`).  The window runs for ``seconds``; with
``trace`` the mix's ``trace_steps`` follow it under the profiler.

Prefill: the window serves batches of ``clients`` prompts, one in
flight, each request's first token the argmax of its last-position
logits, which the window keeps on the device.  The reference runs a
sample of the finished batches, drawn from the seed with a longest one
in it; the numbers are the widest gap by which a served token's logit
lies below the reference's best, and the largest, the 90th-percentile
and the median error of a served row's logits over that row's spread
(:func:`prefill_numbers`).  With ``trace`` the mix's ``trace_batches``
follow the window under the profiler.  A cell compares the numbers its
limits file lists.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import port, weights
from .reference import model as ref_model
from .reference.common import slice_samples
from .trace import WINDOW, Trace, profiler, span
from .traffic.gen import PrefillStream, TrainStream


@dataclass
class Run:
    s: object                      # Sizes
    mix: dict
    device: torch.device
    units: List[dict] = field(default_factory=list)   # steps or batches
    window_s: float = 0.0                 # the window's, on the host clock
    traced_units: List[dict] = field(default_factory=list)   # profiled
    end_to_end: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    setup: Dict[str, float] = field(default_factory=dict)
    numbers: Dict[str, float] = field(default_factory=dict)
    notes: Dict[str, object] = field(default_factory=dict)
    readings: Dict[str, object] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    trace: Optional[Trace] = None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0
                ) -> Dict[str, float]:
    """Each leaf's norm of the port's per-layer tensors (named as the
    port names its parameters), the layers of a leaf taken together."""
    sq: Dict[str, torch.Tensor] = {}
    for name, t in tensors.items():
        parts = name.split(".")
        leaf = ".".join(["layers", *parts[2:]]) if parts[0] == "layers" \
            else name
        x = t.detach().float().square().sum()
        sq[leaf] = sq[leaf] + x if leaf in sq else x
    return {k: math.sqrt(v.item()) * scale for k, v in sq.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[set] = None) -> Dict[str, float]:
    """Each leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    names = sorted(k for k in ref if keep is None or k in keep)
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in names}


timer = time.perf_counter


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _default_train_step(cfg, scfg, *, seq_len, batch, device):
    from repro_torch.launch.steps import make_train_step
    return make_train_step(cfg, scfg, seq_len=seq_len, batch=batch,
                           device=device)


def run_train(s, mix: dict, seed: int, seconds: float, trace: bool,
              device: torch.device, t_start: float,
              make_step: Callable = _default_train_step) -> Run:
    run = Run(s, mix, device)
    t = timer()
    if device.type == "cuda":
        port.build_kernels(s, "train")
    group = port.Group(device)
    try:
        return _train(run, s, mix, seed, seconds, trace, device, t_start,
                      make_step, t)
    finally:
        group.close()


def _train(run: Run, s, mix: dict, seed: int, seconds: float, trace: bool,
           device: torch.device, t_start: float, make_step: Callable,
           t: float) -> Run:
    from repro_torch.launch.steps import StepConfig, batch_to_device
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    run.setup["kernels_s"] = timer() - t
    t = timer()
    dtype = getattr(torch, mix["param_dtype"])
    cfg, model = port.build_model(s, seed, device, dtype)
    adam = AdamWConfig(**mix["adamw"])
    sch = mix["schedule"]
    scfg = StepConfig(sync_mode=mix["sync_mode"],
                      aggr_bytes=mix["aggr_bytes"], remat=mix["remat"],
                      param_dtype=mix["param_dtype"], peak_lr=sch["peak_lr"],
                      warmup_steps=sch["warmup_steps"],
                      total_steps=sch["total_steps"], adam=adam)
    model.requires_grad_(True)
    state = {"params": model,
             "opt": init_opt_state(dict(model.named_parameters()), adam)}
    step_fn = make_step(cfg, scfg, seq_len=mix["seq_len"],
                        batch=mix["global_batch"], device=device)
    stream = TrainStream(mix, seed, s.token_ids)

    def feed(i: int) -> Dict[str, torch.Tensor]:
        return batch_to_device(stream.batch(i), device)
    _sync(device)
    run.setup["weights_s"] = timer() - t
    t = timer()
    losses, grad1 = [], {}
    n_checked = mix["checked_steps"]
    for i in range(n_checked):
        state, loss = step_fn(state, feed(i))
        losses.append(loss.item())
        if i == 0:
            grad1 = _leaf_norms(state["opt"]["m"], 1.0 / (1.0 - adam.b1))
            grad1_s = slice_samples(state["opt"]["m"], 1.0 / (1.0 - adam.b1))
    change = _change_norms(s, seed, device, dtype, model)
    run.counters["sync_allreduces_per_step"] = step_fn.log.count()
    _sync(device)
    run.setup["warmup_s"] = timer() - t

    tokens = mix["global_batch"] * mix["seq_len"]
    unit = {"batch": mix["global_batch"], "seq_len": mix["seq_len"]}
    win_losses = []
    n = n_checked

    def steps(more: Callable[[], bool]) -> None:
        nonlocal state, n
        with span(WINDOW):
            while more():
                with span("perfbench.step"):
                    state, loss = step_fn(state, feed(n))
                win_losses.append(loss)
                n += 1
            _sync(device)

    _sync(device)
    run.setup["setup_s"] = timer() - t_start
    t0 = timer()
    steps(lambda: timer() - t0 < seconds)
    run.window_s = timer() - t0
    run.units = [unit] * (n - n_checked)
    if trace:
        k = n
        with profiler() as prof:
            steps(lambda: n - k < mix["trace_steps"])
        run.trace = Trace(prof)
        run.traced_units = [unit] * (n - k)
    run.attempted = len(win_losses)
    run.failed = sum(1 for x in win_losses if not math.isfinite(x.item()))
    run.end_to_end["train_tokens_per_s"] = \
        len(run.units) * tokens / run.window_s
    run.memory_peak_bytes = _peak(device)
    del state, step_fn, model, win_losses
    _free(device)

    prog = {"losses": losses, "grad1": grad1, "change": change,
            "grad1_s": grad1_s}
    t = timer()
    ref = reference_train(s, mix, seed, device)
    run.numbers = train_numbers(prog, ref)
    run.notes = {"losses": losses, "ref_losses": ref["losses"],
                 "check_s": timer() - t}
    run.readings = {"program": prog, "reference": ref}
    return run


@torch.no_grad()
def _change_norms(s, seed: int, device, dtype, model) -> Dict[str, float]:
    """Each leaf's norm of the port's weights less the seed's."""
    params = port.port_params(model)
    out = {}
    for lf in weights.leaves(s):
        w = weights.draw(lf, seed, device, dtype)
        sq = sum((p.float() - x.float()).square().sum()
                 for p, x in port.placed(lf, w, params, s.n_layers))
        out[lf.name] = math.sqrt(sq.item())
        del w
    return out


def reference_train(s, mix: dict, seed: int, device: torch.device,
                    ) -> dict:
    """The plain reference's first ``checked_steps`` steps, in f32, on
    the seed's weights and batches."""
    W = {k: t.float() for k, t in weights.all_leaves(
        s, seed, device, getattr(torch, mix["param_dtype"])).items()}
    stream = TrainStream(mix, seed, s.token_ids)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in stream.batch(i).items()}
               for i in range(mix["checked_steps"])]
    by_name = {lf.name: lf for lf in weights.leaves(s)}

    def initial(name):
        return weights.draw(by_name[name], seed, device,
                            getattr(torch, mix["param_dtype"]))
    out = ref_model.train(s, W, batches, mix, initial)
    del W
    _free(device)
    return out


def slice_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
               ) -> Dict[str, float]:
    """Each slice's RMS of the difference of the two samples, over the
    RMS of the reference's sample or of the median slice's, whichever is
    larger."""
    names = sorted(ref)
    rms = {k: ref[k].square().mean().sqrt().item() for k in names}
    med = statistics.median(rms.values())
    return {k: (prog[k] - ref[k]).square().mean().sqrt().item()
            / max(rms[k], med, 1e-30) for k in names}


def quantile(values, q: float) -> float:
    """Nearest-rank ``q`` quantile."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers a training cell compares: the worst step's relative
    loss gap; the median leaf's gap of the first clipped gradient's norm
    (the worst leaf's swings with the routing of a token whose experts'
    router logits tie to rounding, up to 1e-4 on some seeds); the worst
    leaf's gap of the change's norm, over the leaves whose reference
    gradient is at least a thousandth of the median leaf's; and the 10th
    percentile over the slices of the first gradient's difference
    (``slice_gaps``): a routing swap moves the slices its tokens reach,
    a lower precision every slice."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    med = statistics.median(ref["grad1"].values())
    moving = {k for k, g in ref["grad1"].items() if g >= 1e-3 * med}
    return {"loss_gap": loss,
            "grad1_median_gap": statistics.median(
                leaf_gaps(prog["grad1"], ref["grad1"]).values()),
            "change_gap": max(leaf_gaps(prog["change"], ref["change"],
                                        moving).values()),
            "grad1_slice_q10": quantile(
                slice_gaps(prog["grad1_s"], ref["grad1_s"]).values(), 0.1)}


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def _default_prefill_step(cfg, scfg, *, seq_len, batch, device):
    from repro_torch.launch.steps import make_prefill_step
    return make_prefill_step(cfg, scfg, seq_len=seq_len, batch=batch,
                             device=device)


def p95(values: List[float]) -> float:
    """Nearest-rank 95th percentile."""
    return quantile(values, 0.95)


def sample_batches(units: List[dict], seed: int, k: int) -> List[int]:
    """``k`` of the finished batches drawn from the seed, the first of
    the longest ones among them."""
    longest = max(u["len"] for u in units)
    first = next(u["index"] for u in units if u["len"] == longest)
    rest = [u["index"] for u in units if u["index"] != first]
    rng = np.random.Generator(np.random.Philox(
        key=weights.sub_seed(seed, "sample")))
    pick = rng.permutation(len(rest))[:max(0, k - 1)]
    return [first] + sorted(rest[j] for j in pick)


def run_prefill(s, mix: dict, seed: int, seconds: float, trace: bool,
                device: torch.device, t_start: float,
                make_step: Callable = _default_prefill_step) -> Run:
    from repro_torch.launch.steps import StepConfig, make_cache
    run = Run(s, mix, device)
    t = timer()
    if device.type == "cuda":
        port.build_kernels(s, "prefill")
    run.setup["kernels_s"] = timer() - t
    t = timer()
    dtype = getattr(torch, mix["param_dtype"])
    cfg, model = port.build_model(s, seed, device, dtype)
    scfg = StepConfig(param_dtype=mix["param_dtype"],
                      cache_dtype=mix["cache_dtype"])
    stream = PrefillStream(mix, seed, s.token_ids)
    b = mix["clients"]
    steps = {n: make_step(cfg, scfg, seq_len=n, batch=b, device=device)
             for n in stream.lengths}
    caches = {n: make_cache(cfg, scfg, batch=b, max_len=n, device=device)
              for n in stream.lengths}

    def serve(prompts: np.ndarray):
        """The batch's first tokens, on the host, and its logits."""
        x = torch.from_numpy(prompts).to(device)
        n = prompts.shape[1]
        for c in caches[n].values():   # a fresh cache for new requests:
            c.zero_()                  # Mamba's prefill starts from it
        logits, _ = steps[n](model, {"tokens": x}, caches[n])
        return logits.argmax(dim=-1).cpu(), logits
    _sync(device)
    run.setup["weights_s"] = timer() - t
    t = timer()
    for j in range(len(stream.lengths)):
        serve(stream.prompts(-1 - j))
    _sync(device)
    run.setup["warmup_s"] = timer() - t

    served: Dict[int, tuple] = {}
    ttft: List[float] = []
    i = 0

    def batches(more: Callable[[], bool], units: List[dict],
                lat: List[float]) -> None:
        nonlocal i
        with span(WINDOW):
            while more():
                prompts = stream.prompts(i)
                with span("perfbench.batch"):
                    t_issue = timer()
                    served[i] = serve(prompts)
                    done = timer()
                lat += [done - t_issue] * b
                units.append({"index": i, "batch": b,
                              "len": prompts.shape[1]})
                i += 1

    _sync(device)
    run.setup["setup_s"] = timer() - t_start
    t0 = timer()
    batches(lambda: timer() - t0 < seconds, run.units, ttft)
    run.window_s = timer() - t0
    if trace:
        with profiler() as prof:
            batches(lambda: len(run.traced_units) < mix["trace_batches"],
                    run.traced_units, [])
            _sync(device)
        run.trace = Trace(prof)
    run.attempted = len(served) * b
    run.failed = 0
    run.end_to_end["ttft_p95_ms"] = p95(ttft) * 1e3
    run.end_to_end["prefill_tokens_per_s"] = \
        sum(u["batch"] * u["len"] for u in run.units) / run.window_s
    run.counters["requests"] = len(ttft)
    run.memory_peak_bytes = _peak(device)
    del model, steps, caches
    _free(device)
    t = timer()
    picked = sample_batches(run.units, seed, mix["checked_batches"])
    got = served_readings(s, mix, seed, device, stream, picked,
                          {i: served[i] for i in picked})
    del served
    run.numbers = prefill_numbers(got)
    run.notes = {"checked_batches": picked,
                 "checked_requests": len(got["gap"]), "check_s": timer() - t}
    run.readings = got
    return run


def prefill_numbers(got: Dict[str, List[float]]) -> Dict[str, float]:
    """The numbers a prefill cell may compare: the widest gap of a served
    token, and the largest, the 90th-percentile and the median error of
    a served row (``served_readings``)."""
    return {"served_gap": max(got["gap"]), "logit_err": max(got["err"]),
            "logit_err_p90": quantile(got["err"], 0.9),
            "logit_err_median": statistics.median(got["err"])}


def served_readings(s, mix: dict, seed: int, device,
                    stream: PrefillStream, picked: List[int],
                    served: Dict[int, tuple], precision: str = "f32"
                    ) -> Dict[str, List[float]]:
    """For each request of the picked batches, against the plain
    reference's f32 logits of its prompt: ``gap``, how far the
    reference's logit of its served token lies below the reference's
    best, and ``err``, the largest error of its logits over the
    reference's spread of that row; ``served[i]`` is batch ``i``'s
    (tokens, logits).  With ``precision`` other than f32 they are the
    reference's own in that precision (the control), not ``served``."""
    W = {k: t.float() for k, t in weights.all_leaves(
        s, seed, device, getattr(torch, mix["param_dtype"])).items()}
    out: Dict[str, List[float]] = {"gap": [], "err": []}
    for i in picked:
        x = torch.from_numpy(stream.prompts(i)).to(device)
        ref = ref_model.last_logits(s, W, x)
        if precision == "f32":
            tok, got = served[i][0].to(device), served[i][1].float()
        else:
            got = ref_model.last_logits(s, W, x, precision)
            tok = got.argmax(-1)
        out["gap"] += (ref.max(-1).values
                       - ref.gather(-1, tok[:, None].long())[:, 0]).tolist()
        out["err"] += ((got - ref).abs().amax(-1) / ref.std(-1)).tolist()
    del W
    _free(device)
    return out
