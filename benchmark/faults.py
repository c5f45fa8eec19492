"""Faults planted under the timed path, to show that the check catches them
(``tests/test_bench_faults.py``) and to read them on the card
(``calibrate.py --side fault:<name>``). Each patches the program for the
length of a ``with`` block.

Training (``train`` driver):
- ``unchanged``: a step returns its state unchanged (no update);
- ``half_batch``: half of each batch left out, the mean taken over the rest;
- ``altered``: one leaf's update applied twice where the step makes it.

Scoring (``score`` driver):
- ``half_batch``: only the first half of a request's rows computed;
- ``altered``: one answer moved by 1e-3 where the call produces it;
- ``unchanged``: each request answered with the previous one's answers.
"""
import contextlib

FAULTS = {"train": ("unchanged", "half_batch", "altered"),
          "score": ("unchanged", "half_batch", "altered")}


@contextlib.contextmanager
def planted(driver: str, name: str):
    import torch

    from multimodn_tpu_torch import model as model_mod
    from multimodn_tpu_torch.core import step

    if name not in FAULTS[driver]:
        raise ValueError(f"no fault {name!r} for the {driver} driver")
    saved = {"gated_update": step.gated_update,
             "train_batch": step.train_batch,
             "fused_chain_forward": model_mod.fused_chain_forward}
    if driver == "train" and name == "unchanged":
        step.gated_update = lambda optimizer, grads, opt_state, params, \
            **kw: opt_state
    elif driver == "train" and name == "half_batch":
        def train_batch(loss_fn, optimizer, params, opt_state, batch, *a,
                        **kw):
            data, targets, mask = batch
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = 0.0
            return saved["train_batch"](loss_fn, optimizer, params,
                                        opt_state, (data, targets, mask),
                                        *a, **kw)
        step.train_batch = train_batch
    elif driver == "train":
        def gated_update(optimizer, grads, opt_state, params, **kw):
            before = params["decoders"][0]["layers"][0]["w"].clone()
            out = saved["gated_update"](optimizer, grads, opt_state, params,
                                        **kw)
            leaf = params["decoders"][0]["layers"][0]["w"]
            leaf.add_(leaf - before)
            return out
        step.gated_update = gated_update
    elif name == "half_batch":
        def forward(spec, params, data, valid, init_row):
            half = valid.shape[0] // 2
            states, outs = saved["fused_chain_forward"](
                spec, params, data[:half].contiguous(),
                valid[:half].contiguous(), init_row)
            pad = valid.shape[0] - half

            def grow(t):
                return torch.cat([t, t.new_zeros((t.shape[0], pad)
                                                 + t.shape[2:])], dim=1)
            return grow(states), [grow(o) for o in outs]
        model_mod.fused_chain_forward = forward
    elif name == "altered":
        def forward(*args):
            states, outs = saved["fused_chain_forward"](*args)
            outs[0][-1, 0, 1] += 1e-3
            return states, outs
        model_mod.fused_chain_forward = forward
    else:
        previous = []

        def forward(*args):
            out = saved["fused_chain_forward"](*args)
            answer = previous[0] if previous else out
            previous[:] = [out]
            return answer
        model_mod.fused_chain_forward = forward
    try:
        yield
    finally:
        step.gated_update = saved["gated_update"]
        step.train_batch = saved["train_batch"]
        model_mod.fused_chain_forward = saved["fused_chain_forward"]
