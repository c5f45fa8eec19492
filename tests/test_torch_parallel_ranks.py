"""Rank functions for ``test_torch_parallel.py`` and
``test_torch_parallel_encoders.py``: each runs in a process of a ``gloo``
group started by ``multimodn_tpu_torch.parallel.dryrun.spawn`` and imports
only torch and the port (no JAX).

They live in a module of their own because a spawned rank imports the module
that defines its function: the test module imports the JAX package, and
importing it in every rank would cost each rank seconds and memory. This
module holds no tests."""
import os

import numpy as np
import torch

import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.core.tree import tree_leaves
from multimodn_tpu_torch.data import ArrayLoader, PartitionDataset


def family_modules(enc, dec, spec):
    """The encoders and decoders of an encoder-family ``spec`` (``spec[
    "encoders"]``: ``(kind, input width)`` pairs) built from the modules
    ``enc`` and ``dec``: the port's here, the JAX package's in the test
    module, so both sides build one model."""
    S = spec["state"]
    compat = spec.get("unbatched", True)
    makers = {
        "transformer": lambda w: enc.TransformerEncoder(
            S, w, embed_dim=8, n_heads=2, n_layers=1, mlp_ratio=2, chunk=4,
            dropout_rate=spec.get("dropout", 0.0)),
        "vit": lambda w: enc.ViTEncoder(
            S, image_size=(4, 4), patch_size=2, channels=3, embed_dim=8,
            n_heads=2, n_layers=1, mlp_ratio=2),
        "lstm": lambda w: enc.LSTMEncoder(S, w, (4,),
                                          unbatched_compat=compat),
        "rnn": lambda w: enc.RNNEncoder(S, w, (4,), unbatched_compat=compat),
        "resnet": lambda w: enc.ResNet(state_size=S),
        "mlp": lambda w: enc.MLPEncoder(S, w, (4,)),
    }
    return ([makers[kind](w) for kind, w in spec["encoders"]],
            [dec.MLPDecoder(S, (4,), 2)])


class Arrays:
    """A dataset of per-modality arrays (images stay 4-D) for either
    package's ``ArrayLoader``."""

    def __init__(self, xs, y):
        self.xs, self.y = list(xs), y

    def __len__(self):
        return len(self.y)

    def arrays(self):
        return self.xs, self.y, None


def build(spec, mesh=None, engine="auto", seed=None):
    """The port's model of a test ``spec`` (the JAX twin is in the test
    module), on the mesh's device or the CPU."""
    S = spec["state"]
    if "encoders" in spec:
        encs, decs = family_modules(tenc, tdec, spec)
        return tmm.MultiModN(
            S, encs, decs, 0.7, 0.3, nan_skip=spec.get("nan_skip", "sample"),
            seed=spec.get("seed", 0) if seed is None else seed,
            device="cpu", mesh=mesh, dp_engine=engine)
    if spec["family"] == "mimic":
        encs = [tenc.MIMICMLPEncoder(S, w, spec["hidden"], dropout=0.0)
                for w in spec["widths"]]
        decs = [tdec.MLPDecoder(S, spec["dec_hidden"], 2)]
    else:
        encs = [tenc.MLPEncoder(S, w, spec["hidden"]) for w in spec["widths"]]
        decs = [tdec.LogisticDecoder(S)]
    kw = {}
    if spec.get("bank") is not None:
        kw["init_state"] = tmm.StaticInitState(
            [np.asarray(b, np.float32) for b in spec["bank"]])
    return tmm.MultiModN(
        S, encs, decs, spec.get("err", 0.7), spec.get("sc", 0.3),
        nan_skip=spec.get("nan_skip", "sample"),
        presence_penalty=spec.get("presence_penalty", 0.0),
        seed=spec.get("seed", 0) if seed is None else seed,
        device="cpu", mesh=mesh, dp_engine=engine, **kw)


def dataset(X, y, widths):
    """A ``PartitionDataset`` of ``X`` cut into ``widths``, or ``Arrays``
    when ``X`` is already a list of modalities (``widths`` None)."""
    return Arrays(X, y) if widths is None else PartitionDataset(
        X, y, list(widths))


def loaders(arrays, widths, batch, shuffle=False):
    (X, y), (Xv, yv) = arrays
    tr = ArrayLoader(dataset(X, y, widths), batch, shuffle=shuffle)
    va = ArrayLoader(dataset(Xv, yv, widths), batch)
    return tr, va


def optimizer(name, lr=0.01):
    """``'sgd'`` is ``SGD(1.0)``: one step moves each parameter by minus
    its gradient."""
    if name == "sgd":
        return tmm.SGD(1.0)
    return {"adam": tmm.Adam, "adam8bit": tmm.Adam8bit}[name](lr)


def history_arrays(h):
    out = {k: {tag: np.asarray(v) for tag, v in getattr(h, k).items()}
           for k in ("loss", "accuracy", "sensitivity", "specificity")}
    out["state_change_loss"] = {"train": np.asarray(h.state_change_loss)}
    return out


def _mesh(shape, axes):
    from multimodn_tpu_torch.parallel import make_mesh
    return None if shape is None else make_mesh(tuple(shape), tuple(axes),
                                                device="cpu")


def train(spec, params, arrays, shape, axes, engine="auto", opt="adam",
          how="fit", epochs=3, batch=16, patience=None):
    """Train the transplanted model on a mesh and return what the test
    compares: histories, scores, whole parameters, and this rank's pieces
    with its mesh coordinates (for the replica check). ``how='step'``: one
    ``train_epoch`` (one batch with ``opt='sgd'``: ``delta`` is minus the
    global gradient). A spec with ``digest`` returns the whole parameters
    from the first rank only and digests of every rank's pieces."""
    mesh = _mesh(shape, axes)
    model = build(spec, mesh, engine)
    if params is not None:
        model.load_state_dict(params)
    tr, va = loaders(arrays, spec.get("widths"), batch)
    h = tmm.MultiModNHistory(["t"])
    o = optimizer(opt)
    out = {}
    if how == "step":
        before = model.state_dict()
        model.train_epoch(tr, o, "cross_entropy", h)
        out["delta"] = [np.asarray(a) - np.asarray(b) for a, b in zip(
            tree_leaves(model.state_dict()), tree_leaves(before))]
    elif how == "fit":
        model.fit(tr, o, "cross_entropy", epochs=epochs, history=h,
                  val_loader=va)
    elif how == "fit_best":
        r = model.fit_best(tr, o, "cross_entropy", epochs=epochs,
                           val_loader=va, history=h, patience=patience)
        out.update(scores=r["scores"], best_epoch=r["best_epoch"],
                   best_params=r["best_params"])
    elif how == "static":
        # The JAX package's test_shard_map_static_init_state_global_round_
        # robin sequence: train_epoch, fit with val, fit_best with patience.
        model.train_epoch(tr, o, "cross_entropy", h)
        model.fit(tr, o, "cross_entropy", epochs=2, history=h,
                  val_loader=va)
        r = model.fit_best(tr, o, "cross_entropy", epochs=4, val_loader=va,
                           patience=3)
        out.update(scores=r["scores"], best_epoch=r["best_epoch"],
                   cycle=model._cycle_offset, epochs_ran=r["epochs_ran"])
    out["history"] = history_arrays(h)
    out["state"] = model.state_dict()
    out["test"] = model.test(va, "cross_entropy")
    out["local"] = [t.numpy().copy() for t in tree_leaves(model.params)]
    out["local_opt"] = [t.float().numpy().copy()
                        for t in tree_leaves(model.opt_state)
                        if torch.is_tensor(t)]
    out["coords"] = None if mesh is None else dict(mesh.coords)
    out["local_shapes"] = [tuple(t.shape) for t in tree_leaves(model.params)]
    if mesh is not None:
        from multimodn_tpu_torch.parallel.sharding import param_specs
        out["specs"] = [tuple(s) for s in _spec_leaves(
            param_specs(model._whole_params(), mesh))]
    if spec.get("digest"):
        out["local"] = [_digest(out["local"])]
        out["local_opt"] = [_digest(out["local_opt"])]
        out["state_digest"] = _digest(tree_leaves(out["state"]))
        if torch.distributed.is_initialized() and \
                torch.distributed.get_rank() > 0:
            out["state"] = out["test"] = out["delta"] = None
    return out


def _digest(arrays) -> str:
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def _same_bits(a, b) -> bool:
    if not torch.is_tensor(a):
        return a == b
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8))


def opt_state_placement(spec, params, arrays):
    """After an epoch on a (data, model) = (2, 2) mesh, each optimizer's
    whole state (gathered by ``opt_state_specs``) cut again by
    ``shard_opt_state``, with the model's specs and with the default read
    from the state, against this rank's live pieces."""
    from multimodn_tpu_torch.parallel import shard_opt_state
    mesh = _mesh((2, 2), ("data", "model"))
    out = {}
    for opt in ("adam", "adam8bit"):
        model = build(spec, mesh)
        model.load_state_dict(params)
        tr, _ = loaders(arrays, spec["widths"], 16)
        model.fit(tr, optimizer(opt), "cross_entropy", epochs=1)
        whole = model._whole_opt_state()
        live = tree_leaves(model.opt_state)
        out[opt] = [all(_same_bits(a, b) for a, b in zip(
            live, tree_leaves(placed))) and len(live) == len(
            tree_leaves(placed)) for placed in (
            model._place_opt_state(whole), shard_opt_state(whole, mesh))]
        out[opt].append(any(a.shape != w.shape for a, w in zip(
            live, tree_leaves(whole)) if torch.is_tensor(a)))
    return out


def _spec_leaves(specs):
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            out.append(node)
    walk(specs)
    return out


def mesh_facts(world):
    """``make_mesh``'s shapes, coordinates, rank selection and error."""
    from multimodn_tpu_torch.parallel import make_mesh
    out = {"default": dict(make_mesh(device="cpu").shape)}
    m = make_mesh((2, world // 2), ("data", "model"), device="cpu")
    out["dp_tp"] = dict(m.shape)
    out["coords"] = m.coords
    out["axis_sizes"] = (m.axis("data").size, m.axis("model").size,
                         m.axis("fold").size)
    sub = make_mesh((2,), ("fold",), devices=[world - 1, 0], device="cpu")
    out["sub_ranks"] = sub.devices.tolist()
    out["sub_coords"] = sub.coords
    try:
        make_mesh((2 * world,), device="cpu")
    except ValueError as e:
        out["too_big"] = str(e)
    return out


def cross_rank_adam(fmt, shape=(6, 8), seed=0):
    """The plain cross-rank ``Adam8bit`` leaf update on a model-axis piece
    (rows split over the ranks, ``row_group``) against the plain update of
    the whole leaf, sliced: returns whether every output matches bit for
    bit, for a leaf with a NaN row too."""
    from multimodn_tpu_torch.ops import fused_adam as fa
    from multimodn_tpu_torch.parallel import make_mesh
    mesh = make_mesh((1, torch.distributed.get_world_size()),
                     ("data", "model"), device="cpu")
    axis = mesh.axis("model")
    g = torch.Generator().manual_seed(seed)
    rows, cols = shape
    p = torch.randn(shape, generator=g)
    grad = torch.randn(shape, generator=g) * 1e-2
    grad[1, 0] = float("nan")
    m = torch.randn(shape, generator=g) * 1e-2
    v = torch.rand(shape, generator=g) * 1e-4
    mq, ms = fa.quantize_rows(m, fmt)
    vq, vs = fa.quantize_rows(v, fmt)
    c12 = torch.tensor([0.1, 0.01])
    whole = fa.multi_leaf_update_ref(
        [(p, grad, mq, ms, vq, vs, c12, None)], lr=1e-3, b1=0.9, b2=0.999,
        eps=1e-8, fmt=fmt)[0]
    k = cols // axis.size
    sl = slice(axis.index * k, (axis.index + 1) * k)
    piece = [t[:, sl].contiguous() for t in (p, grad, mq)] + [ms.clone()] + \
        [vq[:, sl].contiguous(), vs.clone()]
    leaf = (piece[0], piece[1], piece[2], piece[3], piece[4], piece[5], c12,
            None)
    fa.multi_leaf_update([leaf], lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                         fmt=fmt, split=[True], row_group=axis)
    want = [whole[0][:, sl], whole[1][:, sl], whole[2], whole[3][:, sl],
            whole[4]]
    got = [leaf[0], leaf[2], leaf[3], leaf[4], leaf[5]]
    return all(torch.equal(a.view(torch.uint8) if a.dtype != torch.float32
                           else a.view(torch.int32),
                           b.view(torch.uint8) if b.dtype != torch.float32
                           else b.view(torch.int32))
               for a, b in zip(got, want))


def leaf_adam_inputs(shapes, seed=0):
    """Seeded ``multi_leaf_update`` entries ``(p, g, mq, ms, vq, vs, c12,
    None)`` of whole leaves of ``shapes`` (fp8 codes), with a NaN in the
    first gradient of two elements or more."""
    from multimodn_tpu_torch.ops import fused_adam as fa
    g = torch.Generator().manual_seed(seed)
    c12 = torch.tensor([0.1, 0.01])
    out = []
    for shape in shapes:
        grad = torch.randn(shape, generator=g) * 1e-2
        if not out and grad.numel() > 1:
            grad.view(-1)[1] = float("nan")
        mq, ms = fa.quantize_rows(torch.randn(shape, generator=g) * 1e-2)
        vq, vs = fa.quantize_rows(torch.rand(shape, generator=g) * 1e-4)
        out.append((torch.randn(shape, generator=g), grad, mq, ms, vq, vs,
                    c12, None))
    return out


def cross_rank_leaves(whole, axis, split):
    """This rank's entries of whole-leaf ``multi_leaf_update`` entries:
    a split leaf (its last dimension over ``axis``) gives its columns and
    keeps its per-row scales whole; any other leaf is copied whole."""
    def cut(t):
        k = t.shape[-1] // axis.size
        return t[..., axis.index * k:(axis.index + 1) * k].contiguous()

    out = []
    for w, c in zip(whole, split):
        if c:
            out.append((cut(w[0]), cut(w[1]), cut(w[2]), w[3].clone(),
                        cut(w[4]), w[5].clone(), w[6], None))
        else:
            out.append(tuple(t.clone() if torch.is_tensor(t) else t
                             for t in w))
    return out, cut


def cross_rank_tree(spec):
    """K2's plain cross-rank form on one optimizer step of a family's
    leaves (a (1, world) mesh; ``leaf_spec`` marks the split leaves, the
    others, 4-D convolution kernels among them, are whole in the same call)
    against the plain update of the whole leaves, sliced: whether every
    output is bit-equal, and the leaves and split leaves counted."""
    from multimodn_tpu_torch.ops import fused_adam as fa
    from multimodn_tpu_torch.parallel import make_mesh
    from multimodn_tpu_torch.parallel.sharding import leaf_spec
    mesh = make_mesh((1, torch.distributed.get_world_size()),
                     ("data", "model"), device="cpu")
    axis = mesh.axis("model")
    shapes = [tuple(t.shape) for t in tree_leaves(build(spec).params)]
    split = [leaf_spec(s, mesh).split_dim() is not None for s in shapes]
    whole = leaf_adam_inputs(shapes)
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, fmt="fp8")
    want = fa.multi_leaf_update_ref(whole, **kw)
    mine, cut = cross_rank_leaves(whole, axis, split)
    fa.multi_leaf_update(mine, split=split, row_group=axis, **kw)
    equal = True
    for leaf, w, c in zip(mine, want, split):
        take = cut if c else (lambda t: t)
        for a, b in ((leaf[0], take(w[0])), (leaf[2], take(w[1])),
                     (leaf[3], w[2]), (leaf[4], take(w[3])), (leaf[5], w[4])):
            equal &= _same_bits(a.contiguous(), b.contiguous())
    return {"equal": bool(equal), "leaves": len(shapes),
            "split": int(sum(split)), "ndims": sorted({len(s) for s, c in
                                                       zip(shapes, split)
                                                       if not c})}


def experiments(spec, arrays_list, kind, fold_axis_size, params):
    """A fold-axis ``kfold_fit_best`` or a seed-axis ``sweep_fit_best``
    over the world (one rank without a process group), as every rank
    returns it; ``params[seed]`` holds the JAX model's initial weights of
    each seed (None: the port's seeded weights)."""
    from multimodn_tpu_torch import experiments as texp
    mesh = None if fold_axis_size is None else _mesh((fold_axis_size,),
                                                     ("fold",))

    def factory(seed):
        model = build(spec, seed=seed)
        if params is not None:
            model.load_state_dict(params[seed])
        return model

    if kind == "kfold":
        folds = [loaders(a, spec.get("widths"), 8) for a in arrays_list]
        res = texp.kfold_fit_best(factory, folds, tmm.Adam(0.01),
                                  "cross_entropy", epochs=2, mesh=mesh)
    else:
        tr, va = loaders(arrays_list[0], spec.get("widths"), 8)
        res = texp.sweep_fit_best(factory, tr, va, tmm.Adam(0.01),
                                  "cross_entropy", epochs=2,
                                  seeds=(0, 1, 2), mesh=mesh)
    return [{"scores": r["scores"], "best_epoch": r["best_epoch"],
             "state": r["model"].state_dict(),
             "device": str(r["model"].device),
             "t": float(r["model"].opt_state["t"])} for r in res]


def resumable(spec, arrays, shape, axes, ckpt, kill_after=None,
              opt="adam8bit", params=None):
    """``fit_best_resumable`` (4 epochs, one per chunk) on a mesh, stopped
    after ``kill_after`` epochs when given; returns scores and whole
    parameters, or None when stopped."""
    from multimodn_tpu_torch.checkpoint import fit_best_resumable
    mesh = _mesh(shape, axes)
    model = build(spec, mesh)
    if params is not None:
        model.load_state_dict(params)
    tr, va = loaders(arrays, spec.get("widths"), 8, shuffle=True)

    class Stop(Exception):
        pass

    def on_chunk(done, _total):
        if kill_after is not None and done == kill_after:
            raise Stop

    try:
        r = fit_best_resumable(model, tr, optimizer(opt),
                               "cross_entropy", epochs=4,
                               checkpoint_dir=ckpt, val_loader=va,
                               chunk_epochs=1, on_chunk=on_chunk)
    except Stop:
        return None
    return {"scores": r["scores"], "state": model.state_dict(),
            "files": sorted(os.listdir(ckpt))}


def guards(spec, arrays):
    """The mesh-dependent ``dp_engine`` and experiment guards: each case's
    exception type and message."""
    from multimodn_tpu_torch import experiments as texp
    from multimodn_tpu_torch.parallel import make_mesh
    out = {}
    data = make_mesh((torch.distributed.get_world_size(),), ("data",),
                     device="cpu")

    def catch(name, fn):
        try:
            fn()
            out[name] = None
        except Exception as e:      # noqa: BLE001 - the type is compared
            out[name] = (type(e).__name__, str(e))

    model = build(spec, data, "shard_map")
    tr, va = loaders(arrays, spec["widths"], 7)
    catch("batch_size", lambda: model.fit(tr, tmm.Adam(0.01), epochs=1))

    class Sequenced(PartitionDataset):
        def arrays(self):
            xs, t, _ = super().arrays()
            seqs = np.tile(np.arange(len(xs))[None], (t.shape[0], 1))
            seqs[::2] = seqs[::2, ::-1]
            return xs, t, seqs

    (X, y), _ = arrays
    seq = ArrayLoader(Sequenced(X, y, list(spec["widths"])), 8)
    catch("per_batch", lambda: model.train_epoch(seq, tmm.Adam(0.01)))
    fold = make_mesh((torch.distributed.get_world_size(),), ("fold",),
                     device="cpu")
    tr8, va8 = loaders(arrays, spec["widths"], 8)
    catch("model_mesh", lambda: texp.kfold_fit_best(
        lambda s: build(spec, data, seed=s), [(tr8, va8)], tmm.Adam(0.01),
        epochs=1, mesh=fold))
    catch("shard_map_fold", lambda: texp.kfold_fit_best(
        lambda s: build(spec, data, "shard_map", seed=s), [(tr8, va8)],
        tmm.Adam(0.01), epochs=1, mesh=fold))
    catch("no_axis", lambda: texp.sweep_fit_best(
        lambda s: build(spec, seed=s), tr8, va8, tmm.Adam(0.01), epochs=1,
        mesh=data))
    return out


def world(rank, world_size, jobs):
    """Run ``jobs`` (``[(name, function name, kwargs)]``) in order on this
    rank; returns ``{name: result}``."""
    out = {}
    for name, fn, kw in jobs:
        out[name] = globals()[fn](**kw)
    return out
