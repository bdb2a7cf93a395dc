"""1F1B (one-forward-one-backward) pipeline-parallel training schedule.

Counterpart of ``tpu_dist/parallel/pipeline_1f1b.py``. ``fit`` on a
``PipelinedBlocks`` model runs GPipe (``parallel/pipeline_parallel.py``):
autograd holds every microbatch's activations until the backward pipeline
starts, so activation memory grows with M. 1F1B (PipeDream-flush, the
schedule Megatron-LM runs) takes each microbatch's backward as soon as
its forward has cleared the last stage, so a stage holds at most S stage
inputs: O(S) activation memory, independent of M. An outer backward cannot
produce that order, so :func:`one_f_one_b` schedules the backward by
hand and :func:`make_1f1b_train_step` returns ``(loss, grads)`` directly:
a custom-loop step, not differentiated further.

* The timeline is the reference's closed form: stage ``s`` runs the
  forward of microbatch ``i`` at tick ``s + 2i`` and its backward at
  ``2S - 1 - s + 2i``, over ``2(M + S - 1)`` ticks; a tick is a forward, a
  backward or idle.
* A stash of ``min(S, M)`` slots holds the stage inputs in flight; the
  forward runs without a graph, and the backward tick recomputes the
  stage's forward under autograd and takes its gradient with
  ``torch.autograd.grad`` against the cotangent received from the next
  stage (on the last stage, of the microbatch's loss with cotangent
  ``1 / M``). Stage 0 recomputes the layers before the pipeline too and
  takes their gradient.
* Every tick, activations go up (``s -> s + 1``) and cotangents down
  (``s -> s - 1``) in one exchange (``parallel/p2p.py``, counted in
  ``pipeline_parallel.staging``). The reference ppermutes both every tick
  on every device; here a process sends only a valid payload and receives
  only what its neighbour's schedule sends, which both sides know from
  the closed form. The last stage computes nothing at its forward ticks
  (its output would go nowhere); it keeps the input for the backward.
* The stage weights stay the model's stacked leaves, each process its
  ``[1, ...]`` block (``PipelinedBlocks``' placement), so a checkpoint
  moves between the two schedules; the layers before and after the
  pipeline are replicated, their gradients and the loss live on their
  owning stage and are summed over the pipe axis (the others hold zeros,
  so every process gets the same bits), then averaged over the data axis
  with the stage gradients.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_dist_torch.models.layers import apply_chain
from tpu_dist_torch.models.policy import compute_dtype
from tpu_dist_torch.parallel import mesh as mesh_lib
from tpu_dist_torch.parallel.axes import DATA_AXIS, PIPE_AXIS
from tpu_dist_torch.parallel.pipeline_parallel import PipelinedBlocks, _Link


def split_pipelined_model(model):
    """Split a Sequential around its ``PipelinedBlocks`` layer: ``(
    pre_layers, pre_names, pb, pb_name, post_layers, post_names)``. The
    model's own parameters drive both schedules."""
    idx = [i for i, layer in enumerate(model.layers)
           if isinstance(layer, PipelinedBlocks)]
    if len(idx) != 1:
        raise ValueError(
            f"expected exactly one PipelinedBlocks layer, found {len(idx)}")
    (k,) = idx
    return (model.layers[:k], model.layer_names[:k],
            model.layers[k], model.layer_names[k],
            model.layers[k + 1:], model.layer_names[k + 1:])


def _valid(first: int, t: int, m: int) -> bool:
    """A stage's forward (``first = s``) or backward (``first = 2S - 1 -
    s``) tick: ``first + 2i`` for microbatch ``i < m``."""
    return t >= first and (t - first) % 2 == 0 and t < first + 2 * m


def _zeros_like(params: dict) -> dict:
    return {n: torch.zeros_like(p) for n, p in params.items()}


def _add(acc: dict, names, grads) -> None:
    for n, g in zip(names, grads):
        if g is not None:
            acc[n] += g


def one_f_one_b(stage_apply, pre_apply, post_loss, stage_params,
                pre_params, post_params, x_mb, y_mb, *, num_stages: int,
                axis_name: str = PIPE_AXIS, mesh=None, stats=None):
    """The per-process 1F1B loop.

    ``stage_apply(p, a) -> a`` applies this process's stage;
    ``pre_apply(p, x) -> a`` lifts raw inputs to the stage activation (read
    on stage 0); ``post_loss(p, a, y) -> scalar`` maps the last stage's
    activation to the microbatch's mean loss. The params are dicts of
    tensors that require grad; ``x_mb``/``y_mb`` are ``[M, mb, ...]``.
    Returns ``(loss, d_stage, d_pre, d_post)``: the loss and the pre/post
    gradients are nonzero only on their owning stage (the caller sums them
    over the pipe axis), ``d_stage`` is this process's. ``stats`` (a dict)
    receives the stash's ``slots`` and the most stage inputs held at once
    (``max_live``)."""
    if mesh is None:
        from tpu_dist_torch.parallel.strategy import get_strategy

        mesh = get_strategy().mesh
    link = _Link(mesh, axis_name, x_mb.device)
    if link.size != num_stages:
        raise ValueError(f"mesh axis {axis_name!r} has {link.size} "
                         f"processes, not {num_stages} stages")
    m, s, last = x_mb.shape[0], link.stage, num_stages - 1
    slots = min(num_stages, m)
    stash: list = [None] * slots
    live = max_live = 0
    with torch.no_grad():
        a0 = pre_apply(pre_params, x_mb[0])
    like = (tuple(a0.shape), a0.dtype)
    d_stage, d_pre, d_post = (_zeros_like(p) for p in
                              (stage_params, pre_params, post_params))
    loss = torch.zeros((), dtype=torch.float32, device=x_mb.device)
    sp, pp = list(stage_params.values()), list(post_params.values())
    b_first = 2 * num_stages - 1 - s
    fwd_recv = bwd_recv = None
    for t in range(2 * (m + num_stages - 1)):
        up = down = None
        if _valid(s, t, m):
            i = (t - s) // 2
            if s == 0:
                with torch.no_grad():
                    a_in = a0 if i == 0 else pre_apply(pre_params, x_mb[i])
            else:
                a_in = fwd_recv
            stash[i % slots] = a_in
            live += 1
            max_live = max(max_live, live)
            if s < last:
                with torch.no_grad():
                    up = stage_apply(stage_params, a_in)
        elif _valid(b_first, t, m):
            j = (t - b_first) // 2
            a_in = stash[j % slots].detach().requires_grad_()
            stash[j % slots] = None
            live -= 1
            with torch.enable_grad():
                y = stage_apply(stage_params, a_in)
                if s == last:
                    loss_j = post_loss(post_params, y, y_mb[j])
                    grads = torch.autograd.grad(
                        loss_j, [a_in, *sp, *pp],
                        grad_outputs=torch.full_like(loss_j, 1.0 / m),
                        allow_unused=True)
                    loss += loss_j.detach().float()
                    _add(d_post, post_params, grads[1 + len(sp):])
                else:
                    grads = torch.autograd.grad(y, [a_in, *sp],
                                                grad_outputs=bwd_recv,
                                                allow_unused=True)
            da = grads[0]
            _add(d_stage, stage_params, grads[1:1 + len(sp)])
            if s == 0:
                with torch.enable_grad():
                    a = pre_apply(pre_params, x_mb[j])
                    _add(d_pre, pre_params, torch.autograd.grad(
                        a, list(pre_params.values()), grad_outputs=da,
                        allow_unused=True))
            else:
                down = da
        # Activations up, cotangents down: what this process sends, and
        # what its neighbours' schedules send it.
        sends, recvs = [], []
        if up is not None:
            sends.append((up, link.next, 0))
        if down is not None:
            sends.append((down, link.prev, 1))
        takes_up = s > 0 and _valid(s - 1, t, m)
        takes_down = s < last and _valid(2 * num_stages - 2 - s, t, m)
        if takes_up:
            recvs.append((like, link.prev, 0))
        if takes_down:
            recvs.append((like, link.next, 1))
        if sends or recvs:
            got = iter(link.exchange(sends, recvs))
            fwd_recv = next(got) if takes_up else fwd_recv
            bwd_recv = next(got) if takes_down else bwd_recv
    if stats is not None:
        stats.update(slots=slots, max_live=max_live)
    return loss / m, d_stage, d_pre, d_post


def make_1f1b_train_step(model, loss, *, strategy=None):
    """``step(x, y) -> (loss, grads)`` for a pipelined Sequential
    (``build_transformer_lm(pipeline_stages=S)``), scheduled 1F1B over the
    strategy mesh's ``pipe`` axis and split over its ``data`` axis.

    ``x``/``y`` are the global batch; each process takes its data rows.
    ``grads`` is keyed by the model's own parameter names, stage leaves as
    this process's ``[1, ...]`` block, so any optimizer of
    ``ops/optimizers.py`` applies them (``opt.update([grads[n] for n in
    names], state, params)``): the reference's custom-loop use. A model not
    yet placed on the mesh is placed here (process 0's weights, this
    process's stage). ``step.stats`` holds the last call's stash counts."""
    from tpu_dist_torch.parallel.strategy import get_strategy

    strategy = strategy or get_strategy()
    mesh = strategy.mesh
    (pre_layers, pre_names, pb, pb_name,
     post_layers, post_names) = split_pipelined_model(model)
    s_count = pb.num_stages
    if mesh.shape.get(pb.axis_name, 0) != s_count:
        raise ValueError(
            f"mesh has no '{pb.axis_name}' axis of size {s_count}: "
            f"{dict(mesh.shape)}")
    model._place_on(mesh)
    data_size = mesh.shape.get(DATA_AXIS, 1)
    pipe_group = mesh_lib.axis_group(mesh, pb.axis_name)
    data_group = mesh_lib.axis_group(mesh, DATA_AXIS)
    m = pb.microbatches
    named = dict(model.named_parameters())
    prefix = pb_name + ".stages."
    stage_names = [n for n in named if n.startswith(prefix)]
    pre_p = {n: p for n, p in named.items()
             if n.split(".", 1)[0] in pre_names}
    post_p = {n: p for n, p in named.items()
              if n.split(".", 1)[0] in post_names}

    def pre_apply(_, x):
        dtype = compute_dtype()
        if x.is_floating_point() and x.dtype != dtype:
            x = x.to(dtype)  # Sequential's entry cast
        return apply_chain(pre_layers, x)

    def stage_apply(p, a):
        return pb._stage_apply(p, a, None)

    def post_loss(_, a, y):
        logits = apply_chain(post_layers, a)
        if logits.is_floating_point():
            logits = logits.float()  # Sequential's exit cast
        return loss(logits, y)

    def step(x, y):
        if x.shape[0] % (data_size * m):
            raise ValueError(
                f"global batch {x.shape[0]} must divide by data axis "
                f"{data_size} x microbatches {m}")
        x, y = mesh_lib.shard_batch((x, y), mesh)
        mb = x.shape[0] // m
        x_mb = x.reshape(m, mb, *x.shape[1:])
        y_mb = y.reshape(m, mb, *y.shape[1:])
        stage_p = {n[len(prefix):]: named[n][0].detach().requires_grad_()
                   for n in stage_names}
        was = model.training
        model.train()
        try:
            loss_v, d_stage, d_pre, d_post = one_f_one_b(
                stage_apply, pre_apply, post_loss, stage_p, pre_p, post_p,
                x_mb, y_mb, num_stages=s_count, axis_name=pb.axis_name,
                mesh=mesh, stats=step.stats)
        finally:
            model.train(was)
        # Owning-stage partials to global values: the loss and the pre/post
        # gradients live on one stage each (a sum over the pipe axis), then
        # everything averages over the data axis.
        owned = [loss_v, *d_pre.values(), *d_post.values()]
        flat = torch.cat([t.reshape(-1) for t in owned])
        dist.all_reduce(flat, group=pipe_group)
        stage_flat = torch.cat([t.reshape(-1) for t in d_stage.values()])
        if data_size > 1:
            both = torch.cat([flat, stage_flat])
            dist.all_reduce(both, group=data_group)
            both /= data_size
            flat, stage_flat = both[:flat.numel()], both[flat.numel():]
        owned_v = _unflatten(flat, owned)
        grads = dict(zip([*d_pre, *d_post], owned_v[1:]))
        grads.update((prefix + n, g[None]) for n, g in zip(
            d_stage, _unflatten(stage_flat, list(d_stage.values()))))
        return owned_v[0], {n: grads[n] for n in named}

    step.stats = {}
    return step


def _unflatten(flat, like: list) -> list:
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


__all__ = ["make_1f1b_train_step", "one_f_one_b", "split_pipelined_model"]
