"""tracer-purity: the unit bodies a CUDA graph captures must stay pure.

The train step is headed for ``torch.cuda.CUDAGraph`` capture: the
Python of a unit body then runs ONCE, while the graph records its
kernels, and every replay re-issues those kernels without running the
Python again. Whatever the body does outside the tensor algebra is
baked into (or silently dropped from) the replayed step, and a host
sync inside the captured region aborts the capture. Inside the traced
scope — the unit bodies of ``veles_torch/znicz/ops/`` (the ``forward``
of each ``nn.Module``, the ``run`` of the GD and evaluator units, the
``forward``/``backward`` of a ``torch.autograd.Function``) plus
everything they reach through ``self.*`` and same-module helper calls
— this rule bans:

* ``numpy.random.*`` and ``random.*`` — host randomness freezes at
  capture time; draw on the device from an explicit
  ``torch.Generator``;
* ``time.*`` — the capture-time clock is one constant in every replay;
* ``print(...)`` — executes once at capture time, never per step;
* host syncs: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()``, and ``float()``/``int()``/``bool()``
  on a value derived from the body's tensor arguments or ``self``'s
  tensors — a sync is illegal under capture;
* writing a host value to ``self.*`` (a counter, a Python scalar) —
  the write runs once at capture, not per replay, and hides state
  from the checkpoint protocol.

``float()/int()/bool()`` are only flagged when their argument is
(derived from) a tensor argument or a ``self.*`` read: shape
arithmetic (``int(x.shape[0])``, ``x.size(1)``, ``len(x)``,
``int(numpy.prod(shape))`` over static python ints) is legitimate and
common. Assigning a tensor the body computes to ``self.*`` is legal:
a replay refreshes the buffer the captured kernels write.
:func:`traced_functions` exports the scope itself, so a run under
``torch.cuda.set_sync_debug_mode`` can tell a sync inside it from one
in the step's glue.
"""

import ast

from veles_torch.analysis import engine
from veles_torch.analysis.core import Finding, register

#: (class base simple name or None for any class, method names) that
#: enter capture: an nn.Module's forward, an autograd Function's
#: forward/backward, a GD or evaluator unit's run
_TRACED_METHODS = (
    ("Module", ("forward",)),
    ("Function", ("forward", "backward")),
    (None, ("run",)),
)

#: path fragment selecting the captured-op modules
_OPS_FRAGMENT = "znicz/ops"


def _in_ops(mod):
    return _OPS_FRAGMENT in mod.relpath.replace("\\", "/")


_RANDOM_HINT = ("draw on the device from an explicit torch.Generator "
                "(the unit's own, seeded at initialize)")

#: (canonical dotted prefix, why it is banned, fix hint)
_BANNED_PREFIXES = (
    ("numpy.random",
     "host randomness freezes at capture time", _RANDOM_HINT),
    ("random",
     "host randomness freezes at capture time", _RANDOM_HINT),
    ("time",
     "the capture-time clock is one constant in every replay",
     "time the step outside the captured region (CUDA events "
     "around the replay)"),
)

#: tensor methods that copy to the host and wait for the device
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")

#: calls that block the host on the device
_SYNC_CALLS = ("torch.cuda.synchronize",)

#: host conversions flagged on a value derived from a tensor
_CONVERSIONS = ("float", "int", "bool")

#: attribute reads that are static metadata, not tensor data
_META_ATTRS = frozenset(("shape", "ndim", "dtype", "device", "is_cuda",
                         "requires_grad", "layout"))

#: method calls whose result is static metadata, not tensor data
_META_CALLS = frozenset(("size", "dim", "numel", "element_size",
                         "stride", "is_contiguous", "data_ptr",
                         "get_device"))


def _banned(chain, prefixes):
    """(why, hint) when ``chain`` canonicalizes into a banned
    namespace, else None."""
    parts = chain.split(".")
    root = prefixes.get(parts[0])
    if root is None:
        return None
    canonical = ".".join([root] + parts[1:])
    for prefix, why, hint in _BANNED_PREFIXES:
        if canonical == prefix or canonical.startswith(prefix + "."):
            return why, hint
    return None


def _canonical(chain, prefixes):
    parts = chain.split(".")
    root = prefixes.get(parts[0], parts[0])
    return ".".join([root] + parts[1:])


def _param_names(func):
    """The body's parameters that can carry tensors: every one but
    the receiver (``self``) and an autograd Function's context
    (``ctx``), which carry no tensor data of their own."""
    args = func.args
    names = [a.arg for a in args.posonlyargs + args.args
             + args.kwonlyargs]
    for a in (args.vararg, args.kwarg):
        if a is not None:
            names.append(a.arg)
    return [n for n in names if n not in ("self", "ctx")]


def _data_leaves(expr, tensor_attrs):
    """The Name nodes and tensor-attribute reads (``self.weights``,
    ``f.bias``, ``ctx.saved_tensors``) whose DATA ``expr`` reads on the
    device: metadata reads (``x.shape``, ``x.size(0)``, ``len(x)``)
    never touch it, and a host conversion (``x.item()``, ``float(x)``)
    yields a host value, so both are pruned."""
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Attribute) and node.attr in _META_ATTRS:
            continue
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and (
                    fn.attr in _META_CALLS
                    or fn.attr in _SYNC_METHODS and not node.args):
                continue
            if isinstance(fn, ast.Name) \
                    and fn.id in ("len",) + _CONVERSIONS:
                continue
        if isinstance(node, ast.Name):
            yield node
            continue
        if isinstance(node, ast.Attribute) and node.attr in tensor_attrs:
            yield node
            continue
        stack.extend(ast.iter_child_nodes(node))


def _touches(expr, tainted, tensor_attrs):
    """True when ``expr`` reads the data of a tainted local (a tensor
    argument or a name derived from one) or of a tensor attribute."""
    for leaf in _data_leaves(expr, tensor_attrs):
        if isinstance(leaf, ast.Attribute) or leaf.id in tainted:
            return True
    return False


def _assigned_names(node, tainted, tensor_attrs):
    """Local names ``node`` (an assignment) binds from tainted data."""
    if isinstance(node, ast.Assign):
        if not _touches(node.value, tainted, tensor_attrs):
            return []
        out = []
        for t in node.targets:
            if isinstance(t, ast.Name):
                out.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                out.extend(el.id for el in t.elts
                           if isinstance(el, ast.Name))
        return out
    if isinstance(node, ast.AugAssign) \
            and isinstance(node.target, ast.Name) \
            and _touches(node.value, tainted, tensor_attrs):
        return [node.target.id]
    if isinstance(node, (ast.For, ast.comprehension)) \
            and _touches(node.iter, tainted, tensor_attrs):
        return [n.id for n in ast.walk(node.target)
                if isinstance(n, ast.Name)]
    return []


def _tensor_tainted_names(func, params, tensor_attrs):
    """Local names holding device tensors: the tainted ``params``, and
    every name DERIVED from one or from a tensor attribute (``s = x *
    2``, ``w = self.weights``) — propagated to a fixpoint so
    ``float(s)`` is caught as surely as ``float(x)``."""
    tainted = set(params)
    changed = True
    while changed:
        changed = False
        for node in ast.walk(func):
            for name in _assigned_names(node, tainted, tensor_attrs):
                if name not in tainted:
                    tainted.add(name)
                    changed = True
    return tainted


def _calls_torch(expr, prefixes):
    """True when ``expr`` calls into ``torch`` (any import spelling)."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call):
            fn = sub.func
            chain = engine.attr_chain(fn) if isinstance(fn, ast.Attribute) \
                else (fn.id if isinstance(fn, ast.Name) else None)
            if chain and _canonical(chain, prefixes).split(".")[0] \
                    == "torch":
                return True
    return False


def _device_valued(expr, tainted, tensor_attrs, prefixes):
    """True when ``expr`` evidently computes a tensor: it reads a
    tainted local or a tensor attribute, calls into ``torch``, or calls
    a method on ``self``'s data (``self.cache["x"].sum()``). A bare
    ``self.*`` read or a constant is no such evidence: ``self.n =
    self.n + 1`` is a host counter."""
    if _touches(expr, tainted, tensor_attrs) \
            or _calls_torch(expr, prefixes):
        return True
    return any(isinstance(sub, ast.Call)
               and isinstance(sub.func, ast.Attribute)
               and any(isinstance(n, ast.Name) and n.id == "self"
                       for n in ast.walk(sub.func.value))
               for sub in ast.walk(expr))


def _self_target(t):
    return isinstance(t, ast.Attribute) \
        and isinstance(t.value, ast.Name) and t.value.id == "self"


def _follow(graph, mod, cls_name, call):
    """The captured-op helper ``call`` enters, or None: calls resolve
    through the shared call graph (``self.m(...)``, same-module
    functions, module-alias calls, symbol imports) and stay inside the
    captured-op modules; constructors stay unfollowed (attribute setup
    on a FRESH object is not persistent-state mutation)."""
    cls = mod.classes.get(cls_name) if cls_name else None
    target = graph.resolve(mod, cls, call)
    if target is not None and _in_ops(target.module) \
            and target.func.name != "__init__":
        return target
    return None


def _scan_traced(mod, cls_name, func, params, tensor_attrs, findings):
    """Record every impurity of one function of the scope, whose
    ``params`` carry tensors."""
    prefixes = engine.canonical_import_prefixes(mod)
    tainted = _tensor_tainted_names(func, params, tensor_attrs)
    where = "%s.%s" % (cls_name, func.name) if cls_name else func.name

    for node in ast.walk(func):
        # a host value written to self
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if _self_target(t) and not _device_valued(
                        node.value, tainted, tensor_attrs, prefixes):
                    findings.append(Finding(
                        mod.relpath, node.lineno, "tracer-purity",
                        "error",
                        "%s writes a host value to self.%s inside the "
                        "captured scope — runs once at capture, not "
                        "per replay" % (where, t.attr),
                        "keep the value in a device tensor the step "
                        "updates in place, or move the bookkeeping "
                        "outside the captured step"))
        if not isinstance(node, ast.Call):
            continue
        # .item()/.tolist()/.cpu()/.numpy() on anything (incl. chained
        # calls like x.sum().item())
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SYNC_METHODS and not node.args:
            findings.append(Finding(
                mod.relpath, node.lineno, "tracer-purity", "error",
                "%s calls .%s() inside the captured scope — a host "
                "sync, illegal under graph capture"
                % (where, node.func.attr),
                "keep the value on the device; reduce with torch and "
                "read it on the host after the step"))
            continue
        chain = engine.attr_chain(node.func) \
            if isinstance(node.func, ast.Attribute) else None
        # numpy.random.* / random.* / time.* under ANY import spelling
        if chain:
            ban = _banned(chain, prefixes)
            if ban is not None:
                why, hint = ban
                findings.append(Finding(
                    mod.relpath, node.lineno, "tracer-purity",
                    "error",
                    "%s calls %s inside the captured scope — %s"
                    % (where, chain, why), hint))
            elif _canonical(chain, prefixes) in _SYNC_CALLS:
                findings.append(Finding(
                    mod.relpath, node.lineno, "tracer-purity",
                    "error",
                    "%s calls %s inside the captured scope — a host "
                    "sync, illegal under graph capture" % (where, chain),
                    "order work with streams and events; synchronize "
                    "outside the captured step"))
        elif isinstance(node.func, ast.Name):
            fname = node.func.id
            ban = _banned(fname, prefixes)
            if ban is not None:
                why, hint = ban
                findings.append(Finding(
                    mod.relpath, node.lineno, "tracer-purity",
                    "error",
                    "%s calls %s inside the captured scope — %s"
                    % (where, fname, why), hint))
            elif fname == "print":
                findings.append(Finding(
                    mod.relpath, node.lineno, "tracer-purity",
                    "error",
                    "%s calls print() inside the captured scope — it "
                    "runs once at capture time, never per replay"
                    % where,
                    "drop it, or log outside the captured step"))
            elif fname in _CONVERSIONS and node.args \
                    and _touches(node.args[0], tainted, tensor_attrs):
                findings.append(Finding(
                    mod.relpath, node.lineno, "tracer-purity",
                    "error",
                    "%s calls %s() on a device value inside the "
                    "captured scope — a host sync, illegal under "
                    "graph capture" % (where, fname),
                    "keep the value on the device (torch ops) or "
                    "read it on the host after the step"))


def _roots(project):
    """(module, class name, method) of every capture entry point."""
    for mod in project.modules:
        if not _in_ops(mod):
            continue
        for cls in mod.classes.values():
            for base, names in _TRACED_METHODS:
                if base is not None \
                        and not project.is_subclass_of(cls, base):
                    continue
                for mname in names:
                    meth = cls.methods.get(mname)
                    if meth is not None:
                        yield mod, cls, meth


def _tensor_attrs(project, roots):
    """Attribute names that hold tensors on the scope's units: those a
    method of a root class (or of its bases) assigns from a ``torch``
    call, the names its ``PARAMS``/``EXTRA_PARAMS`` declare, and an
    autograd context's ``saved_tensors``."""
    attrs = {"saved_tensors"}
    for _mod, cls, _meth in roots:
        merged = project.class_methods(cls)
        owners = {id(c): c for c, _f in merged.values()}
        owners[id(cls)] = cls
        for owner in owners.values():
            prefixes = engine.canonical_import_prefixes(owner.module)
            for item in owner.node.body:
                if isinstance(item, ast.Assign) and any(
                        isinstance(t, ast.Name)
                        and t.id in ("PARAMS", "EXTRA_PARAMS")
                        for t in item.targets):
                    attrs.update(
                        c.value for c in ast.walk(item.value)
                        if isinstance(c, ast.Constant)
                        and isinstance(c.value, str))
            for func in owner.methods.values():
                for node in ast.walk(func):
                    if isinstance(node, ast.Assign) \
                            and _calls_torch(node.value, prefixes):
                        attrs.update(t.attr for t in node.targets
                                     if _self_target(t))
    return frozenset(attrs)


def _reach(project):
    """{id(func): (module, class name, func, tainted params)} over the
    captured scope: the roots with every parameter a tensor, and each
    helper they reach with the parameters a tensor argument reaches —
    the union over its call sites, to a fixpoint."""
    graph = engine.CallGraph(project)
    roots = list(_roots(project))
    tensor_attrs = _tensor_attrs(project, roots)
    state = {}
    work = []

    def visit(mod, cls_name, func, params):
        key = id(func)
        old = state.get(key)
        params = frozenset(params)
        if old is not None:
            if params <= old[3]:
                return
            params = params | old[3]
        state[key] = (mod, cls_name, func, params)
        work.append(key)

    for mod, cls, meth in roots:
        visit(mod, cls.name, meth, _param_names(meth))
    while work:
        mod, cls_name, func, params = state[work.pop()]
        tainted = _tensor_tainted_names(func, params, tensor_attrs)
        for node in ast.walk(func):
            if not isinstance(node, ast.Call):
                continue
            target = _follow(graph, mod, cls_name, node)
            if target is None:
                continue
            passed = {name for name, arg
                      in engine.map_call_args(node, target).items()
                      if _touches(arg, tainted, tensor_attrs)}
            visit(target.module,
                  target.cls.name if target.cls else None,
                  target.func, passed)
    return state, tensor_attrs


def traced_functions(project):
    """The captured scope: sorted ``(relpath, first line, last line,
    qualified name)`` of every function the rule scans — the entry
    points and what they reach."""
    state, _attrs = _reach(project)
    return sorted((mod.relpath, func.lineno, func.end_lineno,
                   "%s.%s" % (cls_name, func.name) if cls_name
                   else func.name)
                  for mod, cls_name, func, _p in state.values())


@register("tracer-purity", "error",
          "unit bodies captured into a CUDA graph must not do host "
          "I/O, host randomness, host syncs or host-value self writes",
          scope="module")
def check_tracer_purity(project):
    # ONE project-wide scope: a shared helper (conv_math etc.) is
    # scanned once, not re-reported per calling module
    state, tensor_attrs = _reach(project)
    findings = []
    for mod, cls_name, func, params in state.values():
        _scan_traced(mod, cls_name, func, params, tensor_attrs, findings)
    return findings
