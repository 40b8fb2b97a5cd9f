"""graftlint for the port: the static pass over PyTorch hot paths and the
port's contracts (the port's counterpart of ``raft_tpu.lint.rules``).

The JAX package's rules are written for ``jit`` tracing: a tracer in host
code, a retrace, a float64 leak into an x32 program.  Eager PyTorch has no
trace; its hazards are the same in kind but show up as host syncs and
host-to-card copies on the hot path (blocking copies of Python constants
in every scan chunk were once found only by hand, with CUDA's sync debug
mode), as unkeyed knobs, and as shared state in a threaded daemon.  The rule IDs, the ``Violation``
record, the suppression syntax and the baseline are the JAX package's.

=======  ===========================  ========================================
GL101    numpy-on-tensor              ``np.*`` applied to a tensor in hot-path
                                      code (a copy to the host)
GL102    host-cast-on-tensor          ``float()``/``int()``/``bool()``/
                                      ``complex()`` of a tensor in hot-path
                                      code (a sync on the card)
GL103    tensor-python-branch         ``if``/``while``/``assert``/ternary on a
                                      tensor value in hot-path code (an
                                      implicit ``bool``: a sync)
GL105    float64-literal              a hard-coded ``torch.float64``/
                                      ``torch.complex128``/``np.float64``
                                      making a tensor inside a hot-path
                                      function that takes ``dtype``
GL106    host-sync                    ``.item()``/``.tolist()``/``.cpu()``/
                                      ``.numpy()``, ``torch.cuda.
                                      synchronize()``, a stream's or event's
                                      ``.synchronize()``, ``print`` of a
                                      tensor, ``np.asarray`` of a tensor; and
                                      ``torch.tensor``/``torch.as_tensor`` of
                                      host data with ``device=`` (or
                                      ``torch.full`` filled from a host
                                      array) in hot-path code, which should
                                      go through ``core/device.py::
                                      to_device``
GL107    nondeterministic-iteration   iteration over a ``set`` (or unsorted
                                      ``os.listdir``) where the order can
                                      feed a key
GL201    env-knob-contract            a ``RAFT_TPU_*`` read missing from
                                      ``lint/knobs.py``, or a read in
                                      hot-path code of a knob that is not
                                      ``key``
GL202    non-atomic-publish           a direct write under a durable root
                                      (``cache/config.py::cache_root``, the
                                      checkpoint store, the obs sink,
                                      ``obs/ledger.py``): publish through tmp
                                      + ``os.replace``
GL203    unbounded-subprocess         a subprocess without a hard
                                      ``timeout=`` outside ``resilience/
                                      retry.py::checked_subprocess``
GL204    donation-contract            ``donate_argnums`` at a ``parallel/
                                      pipeline.py::run_pipelined`` site that
                                      names an index the staged tuple does
                                      not have, or a donating site that does
                                      not consult ``pipeline.
                                      donation_enabled()``
GL301    unlocked-global-mutation     bare mutation of a module-global
                                      container in a function, outside any
                                      ``with <lock>:``
GL302    check-then-act-memo          ``if k not in d: d[k] = ...`` (or
                                      ``d.get``-then-store) on a module global
                                      without a lock
GL303    env-read-in-concurrent-path  an env read reachable from a concurrent
                                      entry point (``lint/registry.py``
                                      ``CONCURRENT_FUNCTIONS`` or
                                      ``__graftlint_concurrent__``)
GL401    rank-divergent-control-flow  a value that can differ between ranks
                                      (an env read, the clock, random, the
                                      hostname, the pid, ``dist.get_rank()``,
                                      ``LOCAL_RANK``) steering a branch that
                                      reaches a collective, in code reachable
                                      from a multihost entry point
GL402    shared-root-write-collision  a write under a durable root, reachable
                                      from a multihost entry point, whose name
                                      is not salted by the rank
                                      (``dist.get_rank()``; a pid alone does
                                      not pass) nor serialised by a lock
GL404    mesh-axis-contract           an axis name in ``mesh.get_group(...)``,
                                      ``(mesh, "...")`` or ``axis=`` that no
                                      ``init_device_mesh(...,
                                      mesh_dim_names=...)``,
                                      ``global_mesh(axis_names=...)`` or
                                      ``make_mesh(axis=...)`` declares; or a
                                      collective inside a rank-conditional
                                      branch
=======  ===========================  ========================================

Not ported (:data:`NOT_PORTED`):

* GL104 static-arg-hazard: eager PyTorch has no ``static_argnames`` and no
  trace to specialise, so there is no static argument to get wrong;
* GL403 unsharded-large-operand: the port has no ``jit(vmap)`` dispatch to
  shard.  Its data-parallel APIs split their lanes with
  ``multihost.lane_block``, and the audit's sharded check
  (:mod:`raft_tpu_torch.lint.audit`) runs each sharded entry through its
  API's own staging on a ``cpu_world(2)`` and holds each rank's staged
  input bytes at run time instead.

*Hot-path reachability* takes the place of jit reachability.  The seeds:
(a) ``forward``/``backward`` of every ``torch.autograd.Function``
subclass; (b) the step bodies of the drivers of ``solve/dynamics.py`` (its
functions with a ``while`` or ``for`` loop, and the function a driver hands
to ``torch.utils.checkpoint``) and the chunk function handed to
``parallel/pipeline.py::run_pipelined``; (c) the names in an in-module
``__graftlint_hot__ = (...)`` tuple.  Calls and ``from X import y`` edges
propagate it, and so does a closure made by a factory
(``run = make_fn(...); run(x)`` reaches the defs ``make_fn`` returns).
Parameters annotated ``int``/``bool``/``str``/``float``, or defaulting to
a number, string or bool, are not tensors, nor are ``self``, ``ctx``,
``dtype`` and ``device``; names assigned from tensors or from ``torch.*``
tensor factories are tensors (shape, dtype and device reads are not).

Suppression: ``# graftlint: disable=GL106`` (comma-separated, or ``all``)
on the flagged line, or ``# graftlint: disable-file=GL105`` anywhere in the
file.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
import re

from raft_tpu_torch.lint import knobs as _knobs

RULES = {
    "GL101": "numpy-on-tensor",
    "GL102": "host-cast-on-tensor",
    "GL103": "tensor-python-branch",
    "GL105": "float64-literal",
    "GL106": "host-sync",
    "GL107": "nondeterministic-iteration",
    "GL201": "env-knob-contract",
    "GL202": "non-atomic-publish",
    "GL203": "unbounded-subprocess",
    "GL204": "donation-contract",
    "GL301": "unlocked-global-mutation",
    "GL302": "check-then-act-memo",
    "GL303": "env-read-in-concurrent-path",
    "GL401": "rank-divergent-control-flow",
    "GL402": "shared-root-write-collision",
    "GL404": "mesh-axis-contract",
}

#: the JAX package's rules that have no counterpart here, with the reason
NOT_PORTED = {
    "GL104": "static-arg-hazard: eager PyTorch has no static_argnames and no "
             "trace to specialise",
    "GL403": "unsharded-large-operand: the port has no jit(vmap) dispatch; its "
             "APIs split their lanes with multihost.lane_block, held at run time by "
             "the audit's sharded check through each API's own staging",
}

# ---------------------------------------------------------------- GL3xx --
_MUTABLE_CONSTRUCTORS = {"dict", "list", "set", "deque", "Counter",
                         "defaultdict", "OrderedDict"}
_MUTATOR_METHODS = {"append", "appendleft", "extend", "extendleft",
                    "insert", "add", "discard", "remove", "pop",
                    "popitem", "popleft", "clear", "update", "setdefault",
                    "sort", "reverse", "subtract"}

#: in-module declarations of concurrent, multihost and hot entry points
CONCURRENT_DECL = "__graftlint_concurrent__"
MULTIHOST_DECL = "__graftlint_multihost__"
HOT_DECL = "__graftlint_hot__"

# ---------------------------------------------------------------- GL4xx --
#: torch.distributed collectives: every rank must reach them in one order
_DIST_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                     "all_gather_object", "barrier", "broadcast",
                     "broadcast_object_list", "reduce", "reduce_scatter",
                     "reduce_scatter_tensor", "all_to_all",
                     "all_to_all_single", "gather", "scatter",
                     "monitored_barrier"}
#: the port's own collectives (core/collectives.py, re-exported by
#: parallel/multihost.py)
_PORT_COLLECTIVES = {"psum", "pmax", "all_gather"}
_PORT_COLLECTIVE_MODULES = ("raft_tpu_torch.core.collectives",
                            "raft_tpu_torch.parallel.multihost")
#: calls whose result salts a file name per rank
_RANK_SALT_FNS = {"get_rank", "process_tag"}
_DIVERGENT_TIME_FNS = {"time", "time_ns", "perf_counter", "perf_counter_ns",
                       "monotonic", "monotonic_ns", "process_time"}
#: constructors that declare mesh axis names (GL404)
_MESH_DECL_FNS = {"init_device_mesh", "global_mesh", "make_mesh", "DeviceMesh",
                  "cpu_world", "world"}

# ---------------------------------------------------------------- GL2xx --
#: functions whose return value names a durable on-disk root
_DURABLE_ROOT_FNS = {"cache_root", "subdir", "cache_dir", "resolve_dir",
                     "default_dir", "root"}
_NP_WRITE_FNS = {"savez", "savez_compressed", "save"}
_SUBPROCESS_FNS = {"run", "call", "check_call", "check_output", "Popen"}

# ---------------------------------------------------------------- GL1xx --
#: reads that are static on a tensor: no data leaves the card
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "requires_grad",
                 "layout", "names", "type", "index", "grad_fn", "is_leaf",
                 "mesh_dim_names"}
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                   "is_floating_point", "is_complex", "is_contiguous", "stride",
                   "data_ptr", "get_device", "storage_offset"}
_STATIC_CALLS = {"len", "isinstance", "type", "hasattr", "getattr", "id",
                 "callable", "issubclass", "is_tensor", "is_grad_enabled", "fields",
                 "is_dataclass"}
#: parameters that never hold a tensor
_NON_TENSOR_PARAMS = {"self", "cls", "ctx", "dtype", "device", "dev"}
_SCALAR_ANNOTATIONS = {"int", "bool", "str", "float", "complex", "Callable"}
#: ``torch.X(...)`` that return no tensor
_TORCH_NON_TENSOR = {"is_tensor", "is_grad_enabled", "device", "Size", "finfo",
                     "iinfo", "get_default_dtype", "no_grad", "enable_grad",
                     "set_grad_enabled", "inference_mode", "is_floating_point",
                     "is_complex", "numel", "dtype", "Generator", "manual_seed",
                     "get_float32_matmul_precision", "is_inference_mode_enabled",
                     "compile", "promote_types", "result_type", "can_cast",
                     "is_storage", "set_default_dtype", "use_deterministic_algorithms"}
#: torch submodules whose functions return tensors
_TORCH_TENSOR_SUBMODULES = {"linalg", "fft", "special"}
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_CASTS = {"float", "int", "bool", "complex"}
_WIDE_ATTRS = {"float64", "complex128", "double", "cdouble"}

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable(?P<file>-file)?\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_,\s]+)"
)


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str          # repo-relative path
    line: int
    col: int
    func: str          # enclosing function qualname, or "<module>"
    msg: str
    source: str = ""   # stripped source line (baseline fingerprint input)

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{RULES[self.rule]}] {self.msg}")

    def fingerprint(self) -> str:
        """Line-number-free identity used by the committed baseline: the
        rule + file + enclosing function + the stripped source text."""
        h = hashlib.sha256(
            f"{self.rule}|{self.path}|{self.func}|{self.source}".encode()
        ).hexdigest()[:16]
        return f"{self.rule}:{self.path}:{h}"


@dataclasses.dataclass
class FuncInfo:
    node: ast.AST                      # FunctionDef / AsyncFunctionDef / Lambda
    qualname: str
    module: "ModuleInfo"
    parent: "FuncInfo | None"          # lexically enclosing function
    params: list[str] = dataclasses.field(default_factory=list)
    static_params: set[str] = dataclasses.field(default_factory=set)
    hot: bool = False             # reachable from a hot-path seed
    concurrent: bool = False      # reachable from a concurrent entry point
    multihost: bool = False       # reachable from a multihost entry point
    spmd: bool = False            # contains or reaches a collective


class ModuleInfo:
    """Per-file AST plus resolved aliases and the local function table."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.numpy_aliases: set[str] = set()
        self.torch_aliases: set[str] = set()
        self.dist_aliases: set[str] = set()
        self.os_aliases: set[str] = set()
        # local name -> (dotted module, attr-or-None)
        self.import_map: dict[str, tuple[str, str | None]] = {}
        self.functions: dict[str, FuncInfo] = {}
        self.func_by_node: dict[int, FuncInfo] = {}
        self.autograd_classes: set[str] = set()
        self.wide_dtype_names: dict[str, str] = {}
        self.file_suppress: set[str] = set()
        self.line_suppress: dict[int, set[str]] = {}
        self.str_constants: dict[str, str] = {}
        self.mutable_globals: set[str] = set()
        self.concurrent_decls: tuple = ()
        self.multihost_decls: tuple = ()
        self.hot_decls: tuple = ()
        self._collect_suppressions()
        self._collect_imports()
        for node in self.tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Constant) and isinstance(
                    node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.str_constants[t.id] = node.value.value
        self._collect_module_globals()

    def _collect_module_globals(self) -> None:
        """Module-level mutable containers (GL301/GL302) and the
        ``__graftlint_*__`` declarations."""
        decls = {CONCURRENT_DECL: "concurrent_decls",
                 MULTIHOST_DECL: "multihost_decls", HOT_DECL: "hot_decls"}
        for node in self.tree.body:
            targets: list = []
            value = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            if value is None:
                continue
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            if not names:
                continue
            decl = next((decls[n] for n in names if n in decls), None)
            if decl is not None:
                setattr(self, decl, tuple(
                    n.value for n in ast.walk(value)
                    if isinstance(n, ast.Constant) and isinstance(n.value, str)))
                continue
            mutable = isinstance(value, (ast.Dict, ast.List, ast.Set,
                                         ast.DictComp, ast.ListComp,
                                         ast.SetComp))
            if not mutable and isinstance(value, ast.Call):
                fn = value.func
                ctor = (fn.id if isinstance(fn, ast.Name)
                        else fn.attr if isinstance(fn, ast.Attribute)
                        else None)
                mutable = ctor in _MUTABLE_CONSTRUCTORS
            if mutable:
                self.mutable_globals.update(names)

    # -- suppressions ---------------------------------------------------
    def _collect_suppressions(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = {r.strip().upper() for r in m.group("rules").split(",")
                     if r.strip()}
            if "ALL" in rules:
                rules = set(RULES)
            if m.group("file"):
                self.file_suppress |= rules
            else:
                self.line_suppress.setdefault(i, set()).update(rules)

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_suppress:
            return True
        return rule in self.line_suppress.get(line, set())

    # -- imports --------------------------------------------------------
    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for al in node.names:
                    if al.name == "numpy":
                        self.numpy_aliases.add(al.asname or "numpy")
                    elif al.name == "torch":
                        self.torch_aliases.add(al.asname or "torch")
                    elif al.name == "torch.distributed" and al.asname:
                        self.dist_aliases.add(al.asname)
                    elif al.name.startswith("torch.") and not al.asname:
                        self.torch_aliases.add("torch")
                    elif al.name == "os":
                        self.os_aliases.add(al.asname or "os")
                    else:
                        name = al.asname or al.name.split(".")[0]
                        self.import_map[name] = (al.name if al.asname else name, None)
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for al in node.names:
                    name = al.asname or al.name
                    if mod == "torch" and al.name == "distributed":
                        self.dist_aliases.add(name)
                        continue
                    if mod in ("numpy", "torch") and al.name in (
                            "float64", "complex128", "double", "cdouble"):
                        self.wide_dtype_names[name] = f"{mod}.{al.name}"
                    self.import_map[name] = (mod, al.name)

    # -- name classification --------------------------------------------
    def is_numpy(self, node: ast.AST) -> bool:
        return isinstance(node, ast.Name) and node.id in self.numpy_aliases

    def is_torch(self, node: ast.AST) -> bool:
        return isinstance(node, ast.Name) and node.id in self.torch_aliases

    def is_dist(self, node: ast.AST) -> bool:
        """``dist`` (an alias of torch.distributed) or ``torch.distributed``."""
        if isinstance(node, ast.Name):
            return node.id in self.dist_aliases
        return (isinstance(node, ast.Attribute) and node.attr == "distributed"
                and self.is_torch(node.value))

    def _is_os_environ(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Attribute) and node.attr == "environ"
                and isinstance(node.value, ast.Name)
                and node.value.id in self.os_aliases)

    def env_read_name(self, node: ast.AST) -> str | None:
        """The env-var name when ``node`` reads the process environment:
        ``os.environ.get/setdefault(NAME)``, ``os.getenv(NAME)``, or an
        ``os.environ[NAME]`` load; NAME resolves through literals and
        module-level string constants."""

        def resolve(a: ast.AST) -> str | None:
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                return a.value
            if isinstance(a, ast.Name):
                return self.str_constants.get(a.id)
            return None

        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and node.args:
                is_read = (
                    (fn.attr in ("get", "setdefault")
                     and self._is_os_environ(fn.value))
                    or (fn.attr == "getenv"
                        and isinstance(fn.value, ast.Name)
                        and fn.value.id in self.os_aliases))
                if is_read:
                    return resolve(node.args[0])
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
            if self._is_os_environ(node.value):
                return resolve(node.slice)
        return None

    def subprocess_call(self, call: ast.Call) -> str | None:
        """The invoked function name when ``call`` launches a subprocess."""
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr in _SUBPROCESS_FNS:
            base = fn.value
            if isinstance(base, ast.Name):
                if base.id == "subprocess":
                    return fn.attr
                tgt = self.import_map.get(base.id)
                if tgt is not None and tgt[0] == "subprocess":
                    return fn.attr
        elif isinstance(fn, ast.Name):
            tgt = self.import_map.get(fn.id)
            if tgt is not None and tgt[0] == "subprocess" \
                    and (tgt[1] or fn.id) in _SUBPROCESS_FNS:
                return tgt[1] or fn.id
        return None

    def collective_call(self, call: ast.Call) -> str | None:
        """The collective's name when ``call`` is one: ``dist.<collective>``
        or the port's ``psum``/``pmax``/``all_gather`` (bare, from-imported,
        or through the collectives or multihost module)."""
        fn = call.func
        if isinstance(fn, ast.Attribute):
            if fn.attr in _DIST_COLLECTIVES and self.is_dist(fn.value):
                return f"dist.{fn.attr}"
            if fn.attr in _PORT_COLLECTIVES and isinstance(fn.value, ast.Name):
                tgt = self.import_map.get(fn.value.id)
                if tgt is not None:
                    dotted = tgt[0] if tgt[1] is None else f"{tgt[0]}.{tgt[1]}"
                    if dotted in _PORT_COLLECTIVE_MODULES:
                        return fn.attr
            return None
        if isinstance(fn, ast.Name):
            tgt = self.import_map.get(fn.id)
            if tgt is None:
                return None
            if tgt[0] in _PORT_COLLECTIVE_MODULES and tgt[1] in _PORT_COLLECTIVES:
                return tgt[1]
            if tgt[0] == "torch.distributed" and tgt[1] in _DIST_COLLECTIVES:
                return f"dist.{tgt[1]}"
        return None

    def is_rank_call(self, call: ast.Call) -> bool:
        """``dist.get_rank()`` (or ``get_rank`` from torch.distributed)."""
        fn = call.func
        if isinstance(fn, ast.Attribute):
            return fn.attr == "get_rank" and self.is_dist(fn.value)
        if isinstance(fn, ast.Name):
            tgt = self.import_map.get(fn.id)
            return tgt == ("torch.distributed", "get_rank")
        return False

    def torch_tensor_call(self, call: ast.Call) -> str | None:
        """``"torch.X"`` when ``call`` is a ``torch.*`` function that returns
        a tensor (``torch.zeros``, ``torch.linalg.solve``, ...)."""
        fn = call.func
        if not isinstance(fn, ast.Attribute):
            return None
        if self.is_torch(fn.value):
            return None if fn.attr in _TORCH_NON_TENSOR or fn.attr[0].isupper() \
                else f"torch.{fn.attr}"
        if isinstance(fn.value, ast.Attribute) and self.is_torch(fn.value.value) \
                and fn.value.attr in _TORCH_TENSOR_SUBMODULES:
            return f"torch.{fn.value.attr}.{fn.attr}"
        return None

    def is_autograd_base(self, base: ast.AST) -> bool:
        """``torch.autograd.Function`` in any import spelling."""
        if isinstance(base, ast.Attribute) and base.attr == "Function":
            v = base.value
            if isinstance(v, ast.Attribute) and v.attr == "autograd" \
                    and self.is_torch(v.value):
                return True
            if isinstance(v, ast.Name):
                tgt = self.import_map.get(v.id)
                return tgt is not None and (tgt == ("torch", "autograd")
                                            or tgt[0] == "torch.autograd")
            return False
        if isinstance(base, ast.Name):
            tgt = self.import_map.get(base.id)
            return tgt is not None and tgt[0].startswith("torch.autograd") \
                and tgt[1] == "Function"
        return False


def _attr_root(node: ast.AST) -> ast.AST:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node


def _attr_root_name(node: ast.AST) -> str | None:
    root = _attr_root(node)
    return root.id if isinstance(root, ast.Name) else None


def _terminal_name(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _param_names(args: ast.arguments) -> list[str]:
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return names


def _annotation_is_scalar(ann: ast.AST | None) -> bool:
    """True for ``int``/``bool``/``str``/``float`` (incl. ``| None``)."""
    if ann is None:
        return False
    if isinstance(ann, ast.Name):
        return ann.id in _SCALAR_ANNOTATIONS
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        parts = re.split(r"[\[\]|,\s]+", ann.value)
        return any(p in _SCALAR_ANNOTATIONS for p in parts) and not any(
            p in ("Tensor", "ndarray") for p in parts)
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return (_annotation_is_scalar(ann.left)
                or _annotation_is_scalar(ann.right))
    if isinstance(ann, ast.Subscript):
        return _annotation_is_scalar(ann.slice)
    return False


def _literal_default(d: ast.AST | None) -> bool:
    """A number, string or bool default marks a configuration parameter."""
    if isinstance(d, ast.UnaryOp):
        d = d.operand
    return isinstance(d, ast.Constant) and d.value is not None \
        and isinstance(d.value, (int, float, str, bool, complex))


def _static_params(args: ast.arguments) -> set[str]:
    out: set[str] = set()
    pos = args.posonlyargs + args.args
    defaults = dict(zip([a.arg for a in pos[len(pos) - len(args.defaults):]],
                        args.defaults))
    defaults.update({a.arg: d for a, d in zip(args.kwonlyargs, args.kw_defaults)
                     if d is not None})
    for a in pos + args.kwonlyargs:
        if a.arg in _NON_TENSOR_PARAMS or _annotation_is_scalar(a.annotation) \
                or _literal_default(defaults.get(a.arg)):
            out.add(a.arg)
    return out


class _FunctionCollector(ast.NodeVisitor):
    """First pass: every function def with its qualname and parameters;
    methods are named ``Class.method``."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.stack: list[FuncInfo] = []
        self.prefix: list[str] = []

    def _qual(self, name: str) -> str:
        return ".".join(self.prefix + [name])

    def visit_ClassDef(self, node: ast.ClassDef):
        is_fn = any(self.mod.is_autograd_base(b) for b in node.bases)
        qual = self._qual(node.name)
        if is_fn:
            self.mod.autograd_classes.add(qual)
        self.prefix.append(node.name)
        self.generic_visit(node)
        self.prefix.pop()

    def _visit_func(self, node):
        parent = self.stack[-1] if self.stack else None
        qualname = self._qual(node.name)
        fi = FuncInfo(node=node, qualname=qualname, module=self.mod,
                      parent=parent, params=_param_names(node.args),
                      static_params=_static_params(node.args))
        self.mod.functions[qualname] = fi
        self.mod.func_by_node[id(node)] = fi
        self.stack.append(fi)
        self.prefix.append(node.name)
        self.generic_visit(node)
        self.prefix.pop()
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Lambda(self, node: ast.Lambda):
        parent = self.stack[-1] if self.stack else None
        qualname = self._qual(f"<lambda:{node.lineno}:{node.col_offset}>")
        fi = FuncInfo(node=node, qualname=qualname, module=self.mod,
                      parent=parent, params=_param_names(node.args),
                      static_params=_static_params(node.args))
        self.mod.functions[qualname] = fi
        self.mod.func_by_node[id(node)] = fi
        self.stack.append(fi)
        self.generic_visit(node)
        self.stack.pop()


class Analyzer:
    """Whole-tree analysis: reachability propagation + rule checks."""

    def __init__(self, paths: list[str], root: str):
        self.root = root
        self.modules: dict[str, ModuleInfo] = {}     # dotted name -> info
        self.violations: list[Violation] = []
        for p in paths:
            rel = os.path.relpath(p, root)
            try:
                with open(p, "r", encoding="utf-8") as f:
                    src = f.read()
                mod = ModuleInfo(p, rel, src)
            except SyntaxError as e:
                self.violations.append(Violation(
                    rule="GL103", path=rel, line=e.lineno or 0, col=0,
                    func="<module>", msg=f"file does not parse: {e.msg}",
                    source=""))
                continue
            _FunctionCollector(mod).visit(mod.tree)
            self.modules[_dotted_name(rel)] = mod

    # -- resolution -------------------------------------------------------
    def _modules_under(self, dotted: str):
        m = self.modules.get(dotted)
        if m is not None:
            yield m
            return
        for dn, m2 in self.modules.items():
            if dn.startswith(dotted + "."):
                yield m2

    def resolve_external(self, mod: ModuleInfo, name: str) -> list[FuncInfo]:
        """``name`` through ``mod``'s from-imports to functions of other
        analysed modules (a package's re-exports by prefix search)."""
        target = mod.import_map.get(name)
        if target is None or target[1] is None:
            return []
        dotted, attr = target
        out = [m.functions[attr] for m in self._modules_under(dotted)
               if attr in m.functions]
        return out

    def resolve_local(self, mod: ModuleInfo, scope: FuncInfo | None,
                      name: str) -> FuncInfo | None:
        """A bare name visible from ``scope``: nested defs first, then the
        enclosing scopes, then module scope."""
        chain = []
        fi = scope
        while fi is not None:
            chain.append(fi.qualname + ".")
            fi = fi.parent
        chain.append("")
        for prefix in chain:
            hit = mod.functions.get(prefix + name)
            if hit is not None:
                return hit
        return None

    def resolve_name(self, mod, scope, name) -> list[FuncInfo]:
        hit = self.resolve_local(mod, scope, name)
        return [hit] if hit is not None else self.resolve_external(mod, name)

    # -- traversal helpers ------------------------------------------------
    def _scoped_nodes(self, mod: ModuleInfo):
        """(lexically enclosing FuncInfo, node) for every node of the
        module (None at module level), computed once per module."""
        cached = getattr(mod, "_scoped_nodes_cache", None)
        if cached is not None:
            return cached
        out: list = []

        def walk(node: ast.AST, scope: FuncInfo | None) -> None:
            for child in ast.iter_child_nodes(node):
                s = mod.func_by_node.get(id(child), scope)
                out.append((scope, child))
                walk(child, s)

        walk(mod.tree, None)
        mod._scoped_nodes_cache = out
        return out

    def _scoped_calls(self, mod: ModuleInfo):
        return [(scope, n) for scope, n in self._scoped_nodes(mod)
                if isinstance(n, ast.Call)]

    @staticmethod
    def _own_body_walk(fi: FuncInfo) -> list:
        """``fi``'s body without nested defs or lambdas (each is its own
        FuncInfo; the Lambda node itself is included for references),
        computed once per function."""
        cached = getattr(fi, "_body_cache", None)
        if cached is not None:
            return cached
        out: list = []
        stack = list(getattr(fi.node, "body", [])) if not isinstance(
            fi.node, ast.Lambda) else [fi.node.body]
        while stack:
            node = stack.pop()
            out.append(node)
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    continue
                if isinstance(child, ast.Lambda):
                    out.append(child)
                    continue
                stack.append(child)
        fi._body_cache = out
        return out

    def _funcs_named_in(self, mod, scope, expr):
        """Functions referenced by bare name or lambda within ``expr``."""
        for n in ast.walk(expr):
            if isinstance(n, ast.Lambda):
                hit = mod.func_by_node.get(id(n))
                if hit is not None:
                    yield hit
            elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                yield from self.resolve_name(mod, scope, n.id)

    def _referenced_functions(self, fi: FuncInfo) -> list:
        """Every function referenced by bare name from ``fi``'s own body."""
        cached = getattr(fi, "_refs_cache", None)
        if cached is not None:
            return cached
        mod = fi.module
        out: list = []
        for node in self._own_body_walk(fi):
            if isinstance(node, ast.Lambda):
                hit = mod.func_by_node.get(id(node))
                if hit is not None:
                    out.append(hit)
            elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                out.extend(hit for hit in self.resolve_name(mod, fi, node.id)
                           if hit is not fi)
        fi._refs_cache = out
        return out

    def _attr_referenced_functions(self, fi: FuncInfo) -> list:
        """Functions referenced as ``module_alias.func`` from ``fi``'s body."""
        cached = getattr(fi, "_attr_refs_cache", None)
        if cached is not None:
            return cached
        mod = fi.module
        out: list = []
        for node in self._own_body_walk(fi):
            if not (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and isinstance(node.ctx, ast.Load)):
                continue
            tgt = mod.import_map.get(node.value.id)
            if tgt is None:
                continue
            dotted = tgt[0] if tgt[1] is None else f"{tgt[0]}.{tgt[1]}"
            for m2 in self._modules_under(dotted):
                hit = m2.functions.get(node.attr)
                if hit is not None:
                    out.append(hit)
        fi._attr_refs_cache = out
        return out

    def _returned_defs(self, fi: FuncInfo):
        """Nested defs ``fi`` returns by bare name (a factory's closures)."""
        for node in self._own_body_walk(fi):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            vals = node.value.elts if isinstance(node.value, ast.Tuple) \
                else [node.value]
            for v in vals:
                if isinstance(v, ast.Name):
                    cand = self.resolve_local(fi.module, fi, v.id)
                    if cand is not None and cand.parent is fi:
                        yield cand

    def _factory_closures(self, fi: FuncInfo):
        """Closures ``fi`` calls through a name bound, in ``fi`` or a scope
        around it, to a factory's result (``run = make(...); run(x)``)."""
        mod = fi.module
        called = {n.func.id for n in self._own_body_walk(fi)
                  if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                  and self.resolve_local(mod, fi, n.func.id) is None}
        if not called:
            return
        scope = fi
        while scope is not None and called:
            for node in self._own_body_walk(scope):
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)
                        and isinstance(node.value.func, ast.Name)):
                    continue
                names = {t.id for t in node.targets if isinstance(t, ast.Name)}
                if not names & called:
                    continue
                for factory in self.resolve_name(mod, scope, node.value.func.id):
                    yield from self._returned_defs(factory)
            scope = scope.parent

    # -- reachability ------------------------------------------------------
    def _hot_seeds(self, mod: ModuleInfo):
        """(a) autograd forward/backward, (b) driver steps and pipeline
        chunk functions, (c) ``__graftlint_hot__``."""
        for cls in mod.autograd_classes:
            for meth in ("forward", "backward"):
                fi = mod.functions.get(f"{cls}.{meth}")
                if fi is not None:
                    yield fi
        if mod.relpath.replace(os.sep, "/").endswith("solve/dynamics.py"):
            for fi in mod.functions.values():
                if fi.parent is None and "." not in fi.qualname and any(
                        isinstance(n, (ast.While, ast.For))
                        for n in self._own_body_walk(fi)):
                    yield fi
        for scope, call in self._scoped_calls(mod):
            fn_arg = None
            if self._is_checkpoint_call(mod, call) and call.args:
                fn_arg = call.args[0]
            elif _terminal_name(call.func) == "run_pipelined":
                fn_arg = call.args[0] if call.args else next(
                    (k.value for k in call.keywords if k.arg == "fn"), None)
            if fn_arg is not None:
                yield from self._funcs_named_in(mod, scope, fn_arg)
        for name in mod.hot_decls:
            fi = mod.functions.get(name)
            if fi is not None:
                yield fi

    @staticmethod
    def _is_checkpoint_call(mod: ModuleInfo, call: ast.Call) -> bool:
        """``torch.utils.checkpoint.checkpoint`` in any import spelling."""
        fn = call.func
        if isinstance(fn, ast.Name):
            tgt = mod.import_map.get(fn.id)
            return tgt is not None and tgt[0] == "torch.utils.checkpoint"
        if isinstance(fn, ast.Attribute) and fn.attr == "checkpoint":
            v = fn.value
            if isinstance(v, ast.Name):
                tgt = mod.import_map.get(v.id)
                return tgt is not None and (tgt == ("torch.utils", "checkpoint")
                                            or tgt[0] == "torch.utils.checkpoint")
            return isinstance(v, ast.Attribute) and v.attr == "checkpoint" \
                and _attr_root_name(v) in mod.torch_aliases
        return False

    def propagate(self) -> None:
        work: list[FuncInfo] = []

        def mark(fi: FuncInfo | None) -> None:
            if fi is not None and not fi.hot:
                fi.hot = True
                work.append(fi)

        for mod in self.modules.values():
            for fi in self._hot_seeds(mod):
                mark(fi)
        while work:
            fi = work.pop()
            for callee in self._referenced_functions(fi):
                mark(callee)
            for callee in self._factory_closures(fi):
                mark(callee)

    def _propagate_flag(self, flag: str, roots: tuple, decl: str) -> None:
        """Mark ``flag`` on every function host-reachable from ``roots``
        (dotted names) and the modules' ``decl`` names, through bare-name
        and module-attribute references."""
        work: list[FuncInfo] = []

        def mark(fi: FuncInfo | None) -> None:
            if fi is not None and not getattr(fi, flag):
                setattr(fi, flag, True)
                work.append(fi)

        for dotted_mod, mod in self.modules.items():
            for fname in getattr(mod, decl):
                mark(mod.functions.get(fname))
            for r in roots:
                if r.startswith(dotted_mod + "."):
                    mark(mod.functions.get(r[len(dotted_mod) + 1:]))
        while work:
            fi = work.pop()
            for callee in self._referenced_functions(fi):
                mark(callee)
            for callee in self._attr_referenced_functions(fi):
                mark(callee)

    @staticmethod
    def _registry_roots(name: str) -> tuple:
        from raft_tpu_torch.lint import registry as _registry

        return tuple(getattr(_registry, name, ()))

    def _propagate_spmd(self) -> None:
        """Mark functions that contain a collective, then their callers, to
        a fixpoint."""
        for mod in self.modules.values():
            for fi in mod.functions.values():
                if any(isinstance(n, ast.Call) and mod.collective_call(n)
                       for n in self._own_body_walk(fi)):
                    fi.spmd = True
        callers: dict = {}
        for mod in self.modules.values():
            for fi in mod.functions.values():
                for c in (*self._referenced_functions(fi),
                          *self._attr_referenced_functions(fi)):
                    callers.setdefault(id(c), []).append(fi)
        work = [fi for mod in self.modules.values() for fi in mod.functions.values()
                if fi.spmd]
        while work:
            for caller in callers.get(id(work.pop()), ()):
                if not caller.spmd:
                    caller.spmd = True
                    work.append(caller)

    # -- rule application --------------------------------------------------
    def run(self) -> list[Violation]:
        self.propagate()
        self._propagate_flag("concurrent", self._registry_roots(
            "CONCURRENT_FUNCTIONS"), "concurrent_decls")
        self._propagate_flag("multihost", self._registry_roots(
            "MULTIHOST_FUNCTIONS"), "multihost_decls")
        self._propagate_spmd()
        declared_axes = self._declared_axes()
        for mod in self.modules.values():
            self._check_module_wide(mod)
            self._check_contracts(mod)
            self._check_concurrency(mod)
            self._check_spmd(mod, declared_axes)
            for fi in mod.functions.values():
                if fi.hot:
                    self._check_hot_function(fi)
        self.violations.sort(key=lambda v: (v.path, v.line, v.rule))
        return self.violations

    def _emit(self, mod: ModuleInfo, rule: str, node: ast.AST, func: str,
              msg: str) -> None:
        line = getattr(node, "lineno", 0)
        if mod.suppressed(rule, line):
            return
        src = mod.lines[line - 1].strip() if 0 < line <= len(mod.lines) else ""
        self.violations.append(Violation(
            rule=rule, path=mod.relpath, line=line,
            col=getattr(node, "col_offset", 0), func=func, msg=msg,
            source=src))

    # ---- GL107 ----
    def _check_module_wide(self, mod: ModuleInfo) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                self._gl107_call(mod, node)
            elif isinstance(node, (ast.For, ast.comprehension)):
                self._gl107_iter(mod, node)

    @staticmethod
    def _is_set_expr(node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in ("set", "frozenset"))

    def _gl107_iter(self, mod: ModuleInfo, node) -> None:
        it = node.iter
        if self._is_set_expr(it):
            self._emit(mod, "GL107", it, "<module>",
                       "iteration order over a set is arbitrary — feed it "
                       "through sorted() before it can reach a key")
        elif (isinstance(it, ast.Call)
              and isinstance(it.func, ast.Attribute)
              and it.func.attr == "listdir"
              and _attr_root_name(it.func) in mod.os_aliases):
            self._emit(mod, "GL107", it, "<module>",
                       "os.listdir() order is filesystem-dependent — "
                       "sorted() it before hashing or staging")

    def _gl107_call(self, mod: ModuleInfo, call: ast.Call) -> None:
        if isinstance(call.func, ast.Name) and call.func.id in ("tuple", "list"):
            if call.args and self._is_set_expr(call.args[0]):
                self._emit(mod, "GL107", call, "<module>",
                           f"{call.func.id}(set(...)) preserves the "
                           f"arbitrary set order — use sorted(...)")
        if isinstance(call.func, ast.Attribute) and call.func.attr == \
                "join" and call.args and self._is_set_expr(call.args[0]):
            self._emit(mod, "GL107", call, "<module>",
                       "join over a set is order-nondeterministic — "
                       "use sorted(...)")

    # ---- contract rules: GL201, GL202, GL203, GL204, GL303 ----
    def _check_contracts(self, mod: ModuleInfo) -> None:
        for scope, node in self._scoped_nodes(mod):
            qual = scope.qualname if scope else "<module>"
            self._gl201_env_read(mod, scope, node, qual)
            self._gl303_env_read(mod, scope, node, qual)
            if isinstance(node, ast.Call):
                self._gl203_subprocess(mod, node, qual)
                self._gl204_donation(mod, scope, node, qual)
        for fi in mod.functions.values():
            self._gl202_scope(mod, list(self._own_body_walk(fi)), fi.qualname)
        self._gl202_scope(mod, list(self._module_level_nodes(mod)), "<module>")

    def _gl201_env_read(self, mod, scope, node, qual) -> None:
        name = mod.env_read_name(node)
        if name is None or not _knobs.ENV_READ_RE.match(name):
            return
        knob = _knobs.get(name)
        if knob is None:
            self._emit(mod, "GL201", node, qual,
                       f"env knob {name!r} is not registered in "
                       f"raft_tpu_torch/lint/knobs.py — classify it as key, "
                       f"host or fault before reading it (the README table "
                       f"and the salt-site test come from the registry)")
        elif scope is not None and scope.hot \
                and knob.classification != _knobs.KEY:
            self._emit(mod, "GL201", node, qual,
                       f"env knob {name!r} ({knob.classification}) is read in "
                       f"hot-path {qual}(): a knob read per step changes a "
                       f"result no key folds in — classify it 'key' with a "
                       f"salted_via site, or read it once outside the hot path")

    def _gl303_env_read(self, mod, scope, node, qual) -> None:
        if scope is None or not scope.concurrent:
            return
        name = mod.env_read_name(node)
        if name is None or not _knobs.ENV_READ_RE.match(name):
            return
        self._emit(mod, "GL303", node, qual,
                   f"env knob {name!r} is read inside {qual}(), which is "
                   f"reachable from a registered concurrent entry point: a "
                   f"resident process must read knobs once when it arms — "
                   f"hoist the read, or triage with the single-threaded "
                   f"reason")

    def _gl203_subprocess(self, mod, call, qual) -> None:
        fname = mod.subprocess_call(call)
        if fname is None:
            return
        if fname == "Popen":
            self._emit(mod, "GL203", call, qual,
                       "subprocess.Popen carries no hard timeout — a hung "
                       "child wedges the run forever; route through "
                       "resilience.retry.checked_subprocess (or justify the "
                       "raw handle with a suppression)")
            return
        has_timeout = any(
            kw.arg == "timeout" and not (
                isinstance(kw.value, ast.Constant) and kw.value.value is None)
            for kw in call.keywords)
        if not has_timeout:
            self._emit(mod, "GL203", call, qual,
                       f"subprocess.{fname}() without a hard timeout can hang "
                       f"forever — use resilience.retry.checked_subprocess or "
                       f"pass timeout=")

    def _gl204_donation(self, mod, scope, call, qual) -> None:
        if _terminal_name(call.func) != "run_pipelined":
            return
        donate = next((kw.value for kw in call.keywords
                       if kw.arg == "donate_argnums"), None)
        if donate is None:
            return
        idxs = [n.value for n in ast.walk(donate)
                if isinstance(n, ast.Constant) and isinstance(n.value, int)
                and not isinstance(n.value, bool)]
        if not idxs:
            return
        stage = next((kw.value for kw in call.keywords if kw.arg == "stage"),
                     None)
        n_staged = self._staged_arity(mod, scope, stage)
        if n_staged is not None:
            for i in idxs:
                if i >= n_staged or i < -n_staged:
                    self._emit(mod, "GL204", call, qual,
                               f"donate_argnums {i} is out of range for the "
                               f"{n_staged}-item staged tuple — there is no "
                               f"staged input to donate")
        body = [] if scope is None else list(self._own_body_walk(scope))
        consults = any(_terminal_name(n) == "donation_enabled" for n in body
                       if isinstance(n, (ast.Name, ast.Attribute)))
        if not consults:
            self._emit(mod, "GL204", call, qual,
                       f"donating run_pipelined site in {qual}() does not "
                       f"consult pipeline.donation_enabled(): RAFT_TPU_DONATE=0 "
                       f"cannot turn it off")

    def _staged_arity(self, mod, scope, stage) -> int | None:
        """The length of the tuple the ``stage`` callable returns, when every
        return of it is a tuple literal of one length."""
        if stage is None:
            return None
        if isinstance(stage, ast.Lambda):
            body = stage.body
            return len(body.elts) if isinstance(body, ast.Tuple) else None
        if isinstance(stage, ast.Name):
            fi = self.resolve_local(mod, scope, stage.id)
            if fi is None or isinstance(fi.node, ast.Lambda):
                return None
            lens = {len(n.value.elts) if isinstance(n.value, ast.Tuple) else -1
                    for n in self._own_body_walk(fi)
                    if isinstance(n, ast.Return) and n.value is not None}
            if len(lens) == 1 and -1 not in lens:
                return lens.pop()
        return None

    def _module_level_nodes(self, mod: ModuleInfo):
        stack = list(mod.tree.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _durable_taint(self, body: list) -> set:
        """Names in one scope derived from a durable-root call, to a
        fixpoint."""
        tainted: set[str] = set()
        while True:
            changed = False
            for node in body:
                targets, value = _assignment(node)
                if value is None or not _expr_durable(value, tainted):
                    continue
                for t in targets:
                    for nm in _target_names(t):
                        if nm not in tainted:
                            tainted.add(nm)
                            changed = True
            if not changed:
                return tainted

    def _gl202_scope(self, mod: ModuleInfo, body: list, qual: str) -> None:
        """A write-mode ``open`` or ``np.save*`` on a path derived from a
        durable root; the tmp + ``os.replace`` idiom writes through an
        untainted name and passes."""
        if not _touches_durable_root(body):
            return
        tainted = self._durable_taint(body)
        for node in body:
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id == "open" and node.args:
                mode = _open_mode(node)
                if isinstance(mode, str) and any(c in mode for c in "wax+") \
                        and _expr_durable(node.args[0], tainted):
                    self._emit(mod, "GL202", node, qual,
                               f"direct {mode!r}-mode open() on a path under a "
                               f"durable root — a kill mid-write leaves a "
                               f"truncated artifact; publish via "
                               f"tempfile.mkstemp in the same directory + "
                               f"os.replace")
            elif isinstance(fn, ast.Attribute) and fn.attr in _NP_WRITE_FNS \
                    and mod.is_numpy(_attr_root(fn)) and node.args \
                    and _expr_durable(node.args[0], tainted):
                self._emit(mod, "GL202", node, qual,
                           f"np.{fn.attr}() writes directly to a path under a "
                           f"durable root — write to a tempfile.mkstemp handle "
                           f"and os.replace into place")

    # ---- concurrency rules: GL301, GL302 ----
    def _check_concurrency(self, mod: ModuleInfo) -> None:
        if not mod.mutable_globals:
            return
        for fi in mod.functions.values():
            if not isinstance(fi.node, ast.Lambda):
                self._check_gl30x_function(mod, fi)

    def _check_gl30x_function(self, mod: ModuleInfo, fi: FuncInfo) -> None:
        bound = _locally_bound(fi)
        qual = fi.qualname

        def global_name(n: ast.AST) -> str | None:
            if isinstance(n, ast.Name) and n.id in mod.mutable_globals \
                    and n.id not in bound:
                return n.id
            return None

        stored: set = set()
        for node in self._own_body_walk(fi):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript) and global_name(t.value):
                        stored.add(global_name(t.value))
            elif isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and \
                    node.func.attr in _MUTATOR_METHODS:
                g = global_name(node.func.value)
                if g:
                    stored.add(g)

        def check(node: ast.AST, locked: bool) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                held = locked or any(_is_lockish(it.context_expr)
                                     for it in node.items)
                for it in node.items:
                    check(it.context_expr, locked)
                for child in node.body:
                    check(child, held)
                return
            if not locked:
                self._gl301_mutation(mod, node, global_name, qual)
                self._gl302_check_then_act(mod, node, global_name, stored, qual)
            for child in ast.iter_child_nodes(node):
                check(child, locked)

        for stmt in fi.node.body:
            check(stmt, False)

    def _gl301_mutation(self, mod, node, global_name, qual) -> None:
        g = kind = None
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Subscript) and global_name(t.value):
                    g, kind = global_name(t.value), "subscript-assign"
                elif isinstance(node, ast.AugAssign) and global_name(t):
                    g, kind = global_name(t), "augmented-assign"
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and global_name(t.value):
                    g, kind = global_name(t.value), "del"
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATOR_METHODS \
                and global_name(node.func.value):
            g = global_name(node.func.value)
            kind = f".{node.func.attr}()"
        if g is not None:
            self._emit(mod, "GL301", node, qual,
                       f"bare {kind} mutation of module-global {g!r} in "
                       f"{qual}() outside any lock: a multi-threaded resident "
                       f"process interleaves these writes — guard with `with "
                       f"<lock>:`, make the state threading.local, or suppress "
                       f"naming the single-threaded contract")

    def _gl302_check_then_act(self, mod, node, global_name, stored, qual) -> None:
        if isinstance(node, ast.If) and isinstance(node.test, ast.Compare) \
                and len(node.test.ops) == 1 \
                and isinstance(node.test.ops[0], ast.NotIn):
            g = global_name(node.test.comparators[0])
            if g and any(
                    isinstance(n, ast.Assign) and any(
                        isinstance(t, ast.Subscript)
                        and global_name(t.value) == g for t in n.targets)
                    for b in node.body for n in ast.walk(b)):
                self._emit(mod, "GL302", node, qual,
                           f"check-then-act memoization on module-global "
                           f"{g!r}: `if k not in {g}: {g}[k] = ...` "
                           f"double-computes under concurrent callers — hold "
                           f"one lock across the check AND the insert")
            return
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get":
            g = global_name(node.func.value)
            if g and g in stored:
                self._emit(mod, "GL302", node, qual,
                           f"{g}.get(...) outside a lock in {qual}(), which "
                           f"also stores into {g!r}: the get-or-compute races a "
                           f"concurrent insert — hold one lock across check "
                           f"and act")

    # ---- SPMD rules: GL401, GL402, GL404 ----
    def _declared_axes(self) -> set[str]:
        """Every mesh dimension name declared in the linted tree: string
        arguments of the mesh constructors and string defaults of
        ``axis``/``axis_name``/``axis_names``/``mesh_dim_names``
        parameters."""
        axes: set[str] = set()
        axis_params = ("axis", "axis_name", "axis_names", "mesh_dim_names")
        for mod in self.modules.values():
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call):
                    if _terminal_name(node.func) not in _MESH_DECL_FNS:
                        continue
                    subs = list(node.args) if _terminal_name(node.func) in (
                        "global_mesh", "make_mesh") else []
                    subs += [k.value for k in node.keywords if k.arg in axis_params]
                    for sub in subs:
                        axes.update(n.value for n in ast.walk(sub)
                                    if isinstance(n, ast.Constant)
                                    and isinstance(n.value, str))
                elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    args = node.args
                    pos = args.posonlyargs + args.args
                    named = dict(zip([a.arg for a in pos[len(pos) - len(args.defaults):]],
                                     args.defaults))
                    named.update({a.arg: d for a, d in zip(args.kwonlyargs,
                                                           args.kw_defaults)
                                  if d is not None})
                    for pname, d in named.items():
                        if pname in axis_params:
                            axes.update(n.value for n in ast.walk(d)
                                        if isinstance(n, ast.Constant)
                                        and isinstance(n.value, str))
        return axes

    def _divergence_source(self, mod, expr, tainted) -> str | None:
        """A description when ``expr`` carries a value that can differ
        between ranks: an env read (``key`` knobs pass: they move a keyed
        result with the value), the clock, random, the hostname, the pid,
        ``dist.get_rank()``, or a name tainted by one of those."""
        for n in ast.walk(expr):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id in tainted:
                return f"rank-divergent value {n.id!r}"
            name = mod.env_read_name(n)
            if name is not None:
                knob = _knobs.get(name)
                if knob is not None and knob.classification == _knobs.KEY:
                    continue
                return f"env read {name!r}"
            if not isinstance(n, ast.Call):
                continue
            if mod.is_rank_call(n):
                return "dist.get_rank()"
            fn = n.func
            if not isinstance(fn, ast.Attribute):
                continue
            base = _attr_root_name(fn)
            if fn.attr in _DIVERGENT_TIME_FNS and base == "time":
                return f"time.{fn.attr}()"
            if base == "random" or (isinstance(fn.value, ast.Attribute)
                                    and fn.value.attr == "random"):
                return f"random.{fn.attr}()"
            if fn.attr in ("gethostname", "getfqdn") and base == "socket":
                return f"socket.{fn.attr}()"
            if fn.attr == "node" and base == "platform":
                return "platform.node()"
            if fn.attr == "getpid" and base in mod.os_aliases:
                return "os.getpid()"
        return None

    def _divergent_names(self, mod, fi) -> set[str]:
        cached = getattr(fi, "_divergent_cache", None)
        if cached is not None:
            return cached
        tainted: set[str] = set()
        fi._divergent_cache = tainted
        if not any(isinstance(n, ast.Call) and (
                mod.env_read_name(n) is not None or mod.is_rank_call(n)
                or _attr_root_name(n.func) in ("time", "random", "socket", "platform",
                                               *mod.os_aliases))
                   or isinstance(n, ast.Subscript) and mod.env_read_name(n) is not None
                   for n in self._own_body_walk(fi)):
            return tainted
        while True:
            changed = False
            for node in self._own_body_walk(fi):
                targets, value = _assignment(node)
                if value is None or self._divergence_source(
                        mod, value, tainted) is None:
                    continue
                for t in targets:
                    for nm in _target_names(t):
                        if nm not in tainted:
                            tainted.add(nm)
                            changed = True
            if not changed:
                return tainted

    def _check_spmd(self, mod: ModuleInfo, declared_axes: set[str]) -> None:
        self._gl404_axes(mod, declared_axes)
        for fi in mod.functions.values():
            if isinstance(fi.node, ast.Lambda):
                continue
            self._gl404_divergent_collective(mod, fi)
            if fi.multihost:
                self._gl401_function(mod, fi)
                self._gl402_function(mod, fi)

    def _gl401_function(self, mod, fi) -> None:
        tainted = self._divergent_names(mod, fi)
        qual = fi.qualname
        for node in self._own_body_walk(fi):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                decider = node.test
            elif isinstance(node, ast.For):
                decider = node.iter
            else:
                continue
            src = self._divergence_source(mod, decider, tainted)
            if src is None:
                continue
            target = self._spmd_under(mod, fi, node)
            if target is None:
                continue
            kind = type(node).__name__.lower().replace("exp", " expr")
            self._emit(mod, "GL401", node, qual,
                       f"`{kind}` on {src} steers {target} in {qual}(), which "
                       f"is reachable from a multihost entry point: ranks that "
                       f"disagree on the branch skip or reorder the collective "
                       f"and the world deadlocks — take the decision from a "
                       f"value every rank shares (a reduced tensor, keyed "
                       f"configuration)")

    def _spmd_under(self, mod, fi, node) -> str | None:
        """A label when ``node``'s subtree reaches a collective, lexically
        or through a call into an ``spmd`` function (a lexical collective
        under a divergent branch is GL404's)."""
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                if mod.collective_call(n) is not None:
                    continue
                f2 = n.func
                if isinstance(f2, ast.Attribute) and isinstance(f2.value, ast.Name):
                    tgt = mod.import_map.get(f2.value.id)
                    if tgt is not None:
                        dotted = tgt[0] if tgt[1] is None else f"{tgt[0]}.{tgt[1]}"
                        for m2 in self._modules_under(dotted):
                            hit = m2.functions.get(f2.attr)
                            if hit is not None and hit.spmd:
                                return f"a call into collective code ({f2.attr}())"
            elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                for c in self.resolve_name(mod, fi, n.id):
                    if c.spmd:
                        return f"a call into collective code ({n.id}())"
        return None

    def _gl402_function(self, mod, fi) -> None:
        body = self._own_body_walk(fi)
        if not _touches_durable_root(body):
            return
        durable = self._durable_taint(body)
        salted = self._salted_names(mod, body)
        qual = fi.qualname

        def is_salted(expr: ast.AST) -> bool:
            return any(
                (isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                 and n.id in salted)
                or (isinstance(n, ast.Call) and (
                    _terminal_name(n.func) in _RANK_SALT_FNS))
                for n in ast.walk(expr))

        def flag(call, what) -> None:
            self._emit(mod, "GL402", call, qual,
                       f"{what} under a durable shared root in {qual}(), "
                       f"reachable from a multihost entry point, with a name "
                       f"not salted by the rank (dist.get_rank()) and not "
                       f"lock-serialised: two ranks sharing the root clobber "
                       f"each other's artifact (a pid does not help — pids "
                       f"collide across hosts)")

        def check(node: ast.AST, locked: bool) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                held = locked or any(_is_lockish(it.context_expr)
                                     for it in node.items)
                for it in node.items:
                    check(it.context_expr, locked)
                for child in node.body:
                    check(child, held)
                return
            if isinstance(node, ast.Call) and not locked and node.args:
                fn = node.func
                nm = _terminal_name(fn)
                path = node.args[0]
                ok = not _expr_durable(path, durable) or is_salted(path)
                if not ok:
                    mode = _open_mode(node) if isinstance(fn, ast.Name) and nm == "open" \
                        else None
                    if isinstance(mode, str) and any(c in mode for c in "wax+"):
                        flag(node, f"direct {mode!r}-mode open()")
                    elif isinstance(fn, ast.Attribute) and fn.attr in _NP_WRITE_FNS \
                            and mod.is_numpy(_attr_root(fn)):
                        flag(node, f"np.{fn.attr}()")
                    elif nm is not None and "atomic_write" in nm:
                        flag(node, f"{nm}()")
            for child in ast.iter_child_nodes(node):
                check(child, locked)

        for stmt in fi.node.body:
            check(stmt, False)

    def _salted_names(self, mod, body) -> set[str]:
        salted: set[str] = set()

        def has_salt(expr: ast.AST) -> bool:
            return any(
                (isinstance(n, ast.Call) and _terminal_name(n.func) in _RANK_SALT_FNS)
                or (isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                    and n.id in salted)
                for n in ast.walk(expr))

        while True:
            changed = False
            for node in body:
                targets, value = _assignment(node)
                if value is None or not has_salt(value):
                    continue
                for t in targets:
                    for nm in _target_names(t):
                        if nm not in salted:
                            salted.add(nm)
                            changed = True
            if not changed:
                return salted

    def _gl404_axes(self, mod: ModuleInfo, declared: set[str]) -> None:
        """Arm 1: every axis name in ``X.get_group("...")``,
        ``X.get_local_rank("...")``, a ``(mesh, "...")`` pair or ``axis="..."``
        must be declared by some mesh in the linted tree (skipped when none
        is declared)."""
        if not declared:
            return
        for scope, node in self._scoped_nodes(mod):
            qual = scope.qualname if scope else "<module>"
            used: list[tuple[str, ast.AST]] = []
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) and node.func.attr in (
                        "get_group", "get_local_rank"):
                    used += [(a.value, node) for a in node.args
                             if isinstance(a, ast.Constant) and isinstance(a.value, str)]
                used += [(kw.value.value, node) for kw in node.keywords
                         if kw.arg == "axis" and isinstance(kw.value, ast.Constant)
                         and isinstance(kw.value.value, str)]
            elif isinstance(node, ast.Tuple) and len(node.elts) == 2:
                first, second = node.elts
                if isinstance(first, ast.Name) and "mesh" in first.id.lower() \
                        and isinstance(second, ast.Constant) \
                        and isinstance(second.value, str):
                    used.append((second.value, node))
            for axis, n in used:
                if axis not in declared:
                    self._emit(mod, "GL404", n, qual,
                               f"axis name {axis!r} is not declared by any mesh "
                               f"in the linted tree (declared: "
                               f"{sorted(declared)}) — a mistyped dimension "
                               f"fails only when the group is looked up, on "
                               f"every rank")

    def _gl404_divergent_collective(self, mod, fi) -> None:
        """Arm 2: a collective lexically inside a branch whose decision can
        differ between ranks."""
        if not any(isinstance(n, ast.Call) and mod.collective_call(n)
                   for n in self._own_body_walk(fi)):
            return
        tainted = self._divergent_names(mod, fi)
        qual = fi.qualname
        for node in self._own_body_walk(fi):
            if not isinstance(node, (ast.If, ast.While, ast.IfExp)):
                continue
            src = self._divergence_source(mod, node.test, tainted)
            if src is None:
                continue
            in_test = {id(d) for d in ast.walk(node.test)}
            for n in ast.walk(node):
                if id(n) in in_test or not isinstance(n, ast.Call):
                    continue
                coll = mod.collective_call(n)
                if coll is not None:
                    self._emit(mod, "GL404", n, qual,
                               f"collective {coll}() inside a branch on {src} in "
                               f"{qual}(): ranks that skip the branch never join "
                               f"the collective — deadlock; run it "
                               f"unconditionally and mask the contribution")

    # ---- hot-path rules: GL101, GL102, GL103, GL105, GL106, GL201 ----
    def _check_hot_function(self, fi: FuncInfo) -> None:
        mod = fi.module
        tensors = self._tensor_names(fi)
        qual = fi.qualname
        takes_dtype = "dtype" in fi.params
        host_only: set[int] = set()
        for node in self._own_body_walk(fi):
            if isinstance(node, ast.If) and _is_cpu_guard(node.test):
                for stmt in getattr(node, _is_cpu_guard(node.test)):
                    host_only.update(id(n) for n in ast.walk(stmt))
        for node in self._own_body_walk(fi):
            if id(node) in host_only:
                continue
            if isinstance(node, ast.Call):
                self._hot_call_rules(mod, node, tensors, qual)
                if takes_dtype:
                    self._gl105_call(mod, node, qual)
            elif isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
                name = self._first_tensor_mention(mod, node.test, tensors,
                                                  skip_casts=True)
                if name is not None:
                    kind = type(node).__name__.lower().replace("exp", " expr")
                    self._emit(mod, "GL103", node, qual,
                               f"Python `{kind}` on tensor {name} in hot-path "
                               f"{qual}(): the implicit bool() copies the value "
                               f"to the host and waits for the card — decide "
                               f"with torch.where, or sync once per step by "
                               f"design (and triage it)")

    def _gl105_call(self, mod, call: ast.Call, qual: str) -> None:
        for a in list(call.args) + [k.value for k in call.keywords]:
            for n in ast.walk(a):
                wide = None
                if isinstance(n, ast.Attribute) and n.attr in _WIDE_ATTRS and (
                        mod.is_torch(n.value) or (mod.is_numpy(n.value)
                                                  and n.attr in ("float64", "complex128"))):
                    wide = f"{_attr_root_name(n)}.{n.attr}"
                elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                        and n.id in mod.wide_dtype_names:
                    wide = mod.wide_dtype_names[n.id]
                if wide is not None:
                    self._emit(mod, "GL105", n, qual,
                               f"hard-coded {wide} makes a tensor in hot-path "
                               f"{qual}(), which takes dtype: a float32 call "
                               f"computes this in float64 — use dtype")

    def _hot_call_rules(self, mod, node: ast.Call, tensors, qual) -> None:
        func = node.func
        arg_name = None
        for a in list(node.args) + [k.value for k in node.keywords]:
            arg_name = self._first_tensor_mention(mod, a, tensors)
            if arg_name is not None:
                break
        if isinstance(func, ast.Name) and func.id == "print":
            if arg_name is not None:
                self._emit(mod, "GL106", node, qual,
                           f"print() of tensor {arg_name} in hot-path {qual}() "
                           f"copies it to the host and waits for the card")
            return
        if isinstance(func, ast.Name) and func.id in _HOST_CASTS:
            if arg_name is not None:
                self._emit(mod, "GL102", node, qual,
                           f"{func.id}() of tensor {arg_name} in hot-path "
                           f"{qual}() copies the value to the host and waits "
                           f"for the card")
            return
        if not isinstance(func, ast.Attribute):
            return
        if func.attr == "synchronize":
            self._emit(mod, "GL106", node, qual,
                       f"{ast.unparse(func)}() in hot-path {qual}() blocks the "
                       f"host until the card drains")
            return
        if func.attr in _HOST_SYNC_METHODS and not node.args:
            base = self._first_tensor_mention(mod, func.value, tensors)
            if base is not None:
                self._emit(mod, "GL106", node, qual,
                           f".{func.attr}() on tensor {base} in hot-path "
                           f"{qual}() copies it to the host and waits for the "
                           f"card")
                return
        root = _attr_root(func)
        if mod.is_numpy(root):
            if arg_name is None:
                return
            if func.attr in ("asarray", "array", "copy", "ascontiguousarray"):
                self._emit(mod, "GL106", node, qual,
                           f"np.{func.attr}() of tensor {arg_name} in hot-path "
                           f"{qual}() copies it to the host and waits for the "
                           f"card")
            else:
                self._emit(mod, "GL101", node, qual,
                           f"numpy np.{func.attr}() applied to tensor "
                           f"{arg_name} in hot-path {qual}(): it computes on a "
                           f"host copy — use the torch equivalent")
            return
        if mod.is_torch(func.value) and func.attr in ("tensor", "as_tensor", "full") \
                and any(kw.arg == "device" for kw in node.keywords):
            data = node.args[1] if func.attr == "full" and len(node.args) > 1 else (
                node.args[0] if node.args and func.attr != "full" else None)
            if data is None:
                data = next((kw.value for kw in node.keywords
                             if kw.arg in ("data", "fill_value")), None)
            if data is None or self._first_tensor_mention(mod, data, tensors) is not None:
                return
            if func.attr == "full" and not any(
                    isinstance(n, ast.Subscript) or (
                        isinstance(n, ast.Call) and mod.is_numpy(_attr_root(n.func)))
                    for n in ast.walk(data)):
                return      # a scalar fill is a kernel argument, not a copy
            self._emit(mod, "GL106", node, qual,
                       f"torch.{func.attr}() of host data with device= in "
                       f"hot-path {qual}(): a blocking host-to-card copy that "
                       f"waits for the work queued before it — stage it with "
                       f"core.device.to_device (pinned, non-blocking)")

    # ---- tensor taint ----------------------------------------------------
    def _tensor_names(self, fi: FuncInfo) -> set[str]:
        """Tensor-valued names of ``fi``: its parameters (minus the static
        ones), its enclosing scopes' tensor names, and names assigned from
        tensor expressions, to a fixpoint."""
        cache = getattr(fi, "_tensor_cache", None)
        if cache is not None:
            return cache
        mod = fi.module
        tensors: set[str] = set(fi.params) - fi.static_params
        if fi.parent is not None:
            tensors |= self._tensor_names(fi.parent) - set(fi.params)
        if not isinstance(fi.node, ast.Lambda):
            while True:
                changed = False
                for node in self._own_body_walk(fi):
                    if isinstance(node, (ast.For, ast.comprehension)):
                        pairs = _loop_targets(node.target, node.iter)
                    else:
                        targets, value = _assignment(node)
                        if value is None:
                            continue
                        pairs = []
                        for t in targets:
                            if isinstance(t, ast.Tuple) and isinstance(value, ast.Tuple) \
                                    and len(t.elts) == len(value.elts):
                                pairs += list(zip(t.elts, value.elts))
                            else:
                                pairs.append((t, value))
                    for t, v in pairs:
                        if self._first_tensor_mention(mod, v, tensors) is None:
                            continue
                        for name in _bound_target_names(t):
                            if name not in tensors:
                                tensors.add(name)
                                changed = True
                if not changed:
                    break
        fi._tensor_cache = tensors
        return tensors

    def _first_tensor_mention(self, mod, expr, tensors, skip_casts=False) -> str | None:
        """The first tensor in ``expr`` outside static reads (shape, dtype,
        device, ``len``, ``isinstance``, ``is None``), as ``'name'`` or
        ``torch.X(...)``.  ``skip_casts`` also skips explicit host casts and
        ``.item()``/``.tolist()``, which GL102/GL106 flag themselves."""
        skip: set[int] = set()

        def mark_skip(n: ast.AST) -> None:
            skip.update(id(ch) for ch in ast.walk(n))

        for n in ast.walk(expr):
            if id(n) in skip:
                continue
            if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
                mark_skip(n)
            elif isinstance(n, ast.Call):
                fn = n.func
                fname = _terminal_name(fn)
                if fname in _STATIC_CALLS or (
                        isinstance(fn, ast.Attribute) and fn.attr in _STATIC_METHODS):
                    mark_skip(n)
                elif skip_casts and ((isinstance(fn, ast.Name) and fn.id in _HOST_CASTS)
                                     or (isinstance(fn, ast.Attribute)
                                         and fn.attr in ("item", "tolist"))):
                    mark_skip(n)
            elif isinstance(n, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
                mark_skip(n)
            elif isinstance(n, ast.Lambda):
                mark_skip(n)
            elif isinstance(n, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                                ast.DictComp)):
                for g in n.generators:      # the elements decide, not the iteration
                    mark_skip(g)
        for n in ast.walk(expr):
            if id(n) in skip:
                continue
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id in tensors:
                return repr(n.id)
            if isinstance(n, ast.Call):
                t = mod.torch_tensor_call(n)
                if t is not None:
                    return f"{t}(...)"
        return None


def _loop_targets(target: ast.AST, it: ast.AST) -> list:
    """(target, value) pairs of a loop: ``enumerate``'s index and a dict's
    keys (``.items()``) are no tensors; ``zip`` pairs its arguments."""
    if isinstance(target, ast.Tuple) and isinstance(it, ast.Call):
        fname = _terminal_name(it.func)
        if len(target.elts) == 2 and (fname == "enumerate" or (
                fname == "items" and isinstance(it.func, ast.Attribute))):
            return [(target.elts[1], it)]
        if fname == "zip" and len(it.args) == len(target.elts):
            return list(zip(target.elts, it.args))
    return [(target, it)]


def _is_cpu_guard(test: ast.AST) -> str | None:
    """``"body"`` when ``test`` holds only for CPU tensors
    (``x.device.type == "cpu"``, ``... != "cuda"``, ``not x.is_cuda``),
    ``"orelse"`` when only for CUDA ones: that branch never syncs the card."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
            and isinstance(test.operand, ast.Attribute) and test.operand.attr == "is_cuda":
        return "body"
    if isinstance(test, ast.Attribute) and test.attr == "is_cuda":
        return "orelse"
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.left, ast.Attribute) and test.left.attr == "type" \
            and isinstance(test.comparators[0], ast.Constant):
        eq = isinstance(test.ops[0], ast.Eq)
        ne = isinstance(test.ops[0], ast.NotEq)
        val = test.comparators[0].value
        if (eq and val == "cpu") or (ne and val == "cuda"):
            return "body"
        if (eq and val == "cuda") or (ne and val == "cpu"):
            return "orelse"
    return None


def _assignment(node: ast.AST):
    """(targets, value) of an assignment-like node, else ([], None)."""
    if isinstance(node, ast.Assign):
        return node.targets, node.value
    if isinstance(node, (ast.AnnAssign, ast.AugAssign, ast.NamedExpr)) \
            and node.value is not None:
        return [node.target], node.value
    return [], None


def _open_mode(call: ast.Call):
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    return mode


def _touches_durable_root(nodes) -> bool:
    """Whether a scope's nodes call a durable-root function at all."""
    return any(isinstance(n, ast.Call) and _terminal_name(n.func) in _DURABLE_ROOT_FNS
               for n in nodes)


def _expr_durable(expr: ast.AST, tainted: set[str]) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Call) and _terminal_name(n.func) in _DURABLE_ROOT_FNS:
            return True
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                and n.id in tainted:
            return True
    return False


def _target_names(t: ast.AST):
    """Names an assignment target stores into (``br[j] = x`` stores into
    ``br``)."""
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _target_names(e)
    elif isinstance(t, ast.Starred):
        yield from _target_names(t.value)
    elif isinstance(t, (ast.Subscript, ast.Attribute)):
        yield from _target_names(t.value)


def _is_lockish(expr: ast.AST) -> bool:
    """Is ``with <expr>:`` a lock acquisition?  Judged by the terminal
    identifier: any name mentioning lock/mutex, plus the threading
    synchronisation constructors."""
    node = expr.func if isinstance(expr, ast.Call) else expr
    name = _terminal_name(node)
    if name is None:
        return False
    low = name.lower()
    return ("lock" in low or "mutex" in low
            or name in ("Condition", "Semaphore", "BoundedSemaphore"))


def _bound_target_names(t: ast.AST):
    """Names a target binds (a subscript or attribute store binds none)."""
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _bound_target_names(e)
    elif isinstance(t, ast.Starred):
        yield from _bound_target_names(t.value)


def _locally_bound(fi: FuncInfo) -> set:
    """Names shadowing a module global inside ``fi``."""
    bound = set(fi.params)
    global_decls: set = set()
    if isinstance(fi.node, ast.Lambda):
        return bound
    for node in Analyzer._own_body_walk(fi):
        if isinstance(node, ast.Global):
            global_decls.update(node.names)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                bound.update(_bound_target_names(t))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign, ast.NamedExpr)):
            bound.update(_bound_target_names(node.target))
        elif isinstance(node, ast.For):
            bound.update(_bound_target_names(node.target))
        elif isinstance(node, ast.withitem) and node.optional_vars:
            bound.update(_bound_target_names(node.optional_vars))
        elif isinstance(node, ast.comprehension):
            bound.update(_bound_target_names(node.target))
    return bound - global_decls


def _dotted_name(relpath: str) -> str:
    name = relpath[:-3] if relpath.endswith(".py") else relpath
    name = name.replace(os.sep, ".")
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    return name


def collect_py_files(paths: list[str], root: str) -> list[str]:
    """Expand lint targets to .py files.  A target that does not exist
    raises: a gate that lints nothing because of a mistyped path would
    report green forever."""
    out: list[str] = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if not os.path.exists(ap):
            raise FileNotFoundError(
                f"lint target {p!r} does not exist under {root!r}")
        if os.path.isdir(ap):
            for dirpath, dirnames, filenames in sorted(os.walk(ap)):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in ("__pycache__", "_build"))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
        elif ap.endswith(".py"):
            out.append(ap)
        else:
            raise ValueError(f"lint target {p!r} is neither a directory "
                             f"nor a .py file")
    return out


def lint_paths(paths: list[str], root: str) -> list[Violation]:
    """Run every rule over the .py files under ``paths`` (dirs recurse)."""
    return Analyzer(collect_py_files(paths, root), root).run()


def hot_functions(paths: list[str], root: str) -> list[str]:
    """``relpath::qualname`` of every hot-path function under ``paths``."""
    a = Analyzer(collect_py_files(paths, root), root)
    a.propagate()
    return sorted(f"{mod.relpath}::{fi.qualname}" for mod in a.modules.values()
                  for fi in mod.functions.values() if fi.hot)


def collect_env_reads(paths: list[str], root: str) -> dict:
    """Every ``RAFT_TPU_*`` and ``RAFT_EVIDENCE_*`` env read under ``paths``:
    ``{knob name: ["relpath:line", ...]}``."""
    a = Analyzer(collect_py_files(paths, root), root)
    out: dict = {}
    for mod in a.modules.values():
        for _scope, node in a._scoped_nodes(mod):
            name = mod.env_read_name(node)
            if name is not None and _knobs.ENV_READ_RE.match(name):
                out.setdefault(name, []).append(
                    f"{mod.relpath}:{getattr(node, 'lineno', 0)}")
    return out
