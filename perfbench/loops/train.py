"""The training loop: the port's train step (``make_train_step``: the loss
through ``LM.loss_fn`` with a layer recomputed in the backward and #9 on
the forward, AdamW on fp32 masters) on the mix's batches.

Set-up builds the one step object with its model and optimizer state and
drives it through the mix's ``checked_steps`` on the first batches; they
warm every shape up, and what the comparison needs is read from them
there: each step's loss, each leaf's norm of the first gradient as the
optimizer got it (its first moment after one step over ``1 - b1``), and
each leaf's norm of its change after the checked steps (its fp32 master
against the weights drawn again from the seed). The same object then runs
the window on the following batches. The window closes at the first step
end at or after ``--seconds``, so it holds whole steps only; a traced run
traces the steps that start in its last ``SPAN_SECONDS`` (at least one).

After the window the program is freed, the fp32 reference runs the
checked steps, and the loss, gradient and change gaps are compared with
the cell's limits.
"""
from __future__ import annotations

import gc

import torch

from perfbench import counts, weights
from perfbench import trace as tracing
from perfbench.bench import Outcome
from perfbench.data import SyntheticLM
from perfbench.loops.serving import build_model, clock, load_kernels
from perfbench.reference import train as ref
from perfbench.trace import Trace


def _program_step(model, opt: dict):
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.step import TrainState, make_train_step
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    state = TrainState(params=params, opt_state=adamw_init(params),
                       step=torch.zeros((), dtype=torch.int32,
                                        device=model.device))
    cfg = AdamWConfig(**{k: v for k, v in opt.items() if k != "no_decay"})
    return state, make_train_step(model, cfg)


def flash_launches() -> int:
    import repro_torch.kernels as K
    return K.flash_attention.launches


def run(cell, seed, seconds, trace, device, t_start):
    mix, a = cell.traffic, weights.Arch(cell.config)
    B, S, n_checked = int(mix["batch"]), int(mix["seq_len"]), \
        int(mix["checked_steps"])
    parts = {"imports": clock() - t_start}
    t = clock()
    load_kernels(device)
    parts["libraries"] = clock() - t
    t = clock()
    model = build_model(cell, seed, device, remat=True)
    data = SyntheticLM(a.V, S, B, seed, int(mix.get("branching", 4)))
    parts["weights"] = clock() - t
    t = clock()
    state, step = _program_step(model, mix["optimizer"])
    parts["optimizer"] = clock() - t
    t = clock()
    b1 = float(mix["optimizer"]["b1"])
    prog = {"loss": [], "grad": {}, "change": {}}
    for k in range(n_checked):
        state, m = step(state, data.batch(k))
        prog["loss"].append(float(m["loss"]))
        if k == 0:
            prog["grad"] = {n: float(torch.linalg.vector_norm(mu.float()))
                            / (1.0 - b1)
                            for n, mu in state.opt_state["mu"].items()}
    with torch.no_grad():
        for n, w in state.opt_state["master"].items():
            prog["change"][n] = float(torch.linalg.vector_norm(
                w - weights.draw(a, seed, n, device, torch.float32)))
    if device.type == "cuda":
        torch.cuda.synchronize()
    parts["checked_steps"] = clock() - t
    if trace:
        Trace.warm()
    t0 = clock()
    setup_s = t0 - t_start
    trace_s = tracing.SPAN_SECONDS
    tr, span = None, None         # traced: the window's last trace_s seconds
    steps = 0
    while True:
        if trace and tr is None and clock() - t0 >= seconds - trace_s:
            tr = Trace()
            tr.start()
            span = (clock(), steps, flash_launches())
        with torch.profiler.record_function("perfbench.train_step"):
            state, m = step(state, data.batch(n_checked + steps))
            float(m["loss"])
        steps += 1
        if clock() - t0 >= seconds and (tr is not None or not trace):
            break
    window = clock() - t0
    ctx = {"arch": a, "trace": tr}
    if tr is not None:
        # the device trace's metrics over the traced span; the host clock's
        # over the steps before it, which the profiler does not slow
        n_flash = flash_launches() - span[2]
        tr.stop()
        ctx.update(seconds=span[0] - t0,
                   useful_flops=span[1] * counts.train_step_flops(a, B, S),
                   flash_calls=[(B, S, n_flash)])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    ctx["memory_peak_bytes"] = peak
    e2e = {"train_tok_s": steps * B * S / window, "setup_s": setup_s}
    del state, step, model, m
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    batches = [data.batch(k) for k in range(n_checked)]
    reference = ref.train(a, seed, batches, mix["optimizer"], device)
    got = ref.gaps(prog, reference)
    ctx.update(batches=batches, reference=reference)
    checks = {n: (v, float(cell.limits[n])) for n, v in got.items()}
    return Outcome(e2e, ctx, checks, steps, 0, peak, parts, tr)
