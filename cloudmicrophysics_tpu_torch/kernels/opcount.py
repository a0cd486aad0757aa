"""Dynamic operation counts of the column kernels, from their SASS.

Two sources meet here:

* the SASS of a kernel library built with ``-lineinfo``, with its line
  table (``cuobjdump -xelf`` extracts the cubin, ``nvdisasm -g -gi`` prints
  each instruction under the source line it came from and the chain of
  inlined calls that led there) and its branches;
* how often each region of the source ran: for K5, the probe build of
  ``csrc/column_p3.cu`` (``-DK5_PROBE``), whose ``K5_COUNT(region[,
  unroll])`` sites count per thread how often each region ran (an unroll
  factor is a number, or a constant of the source whose value the caller
  gives for the build); for K1-K4,
  the per-cell function ``cell_step`` (:func:`function_block`), which runs
  once per cell at its one call site (:func:`call_site_tally`).

The region of a site is the innermost brace block around it. An
instruction belongs to the innermost region that holds a line of its
inline chain, walked from the innermost call outward. A region inlined at
several call sites has a copy under each (told apart by the rest of the
chain), and each copy runs for its own calls.

A copy's instructions do not all run each time it runs: an arm of a branch
inside it (of the source, or of the CUDA math library's inline code) may
be skipped. So each copy is counted along its least path: the path through
the function's control-flow graph, from the copy's first instruction
through its largest basic block (its main straight-line code) to its last
instruction, that runs the fewest of the copy's instructions. The largest
block keeps the path in the region's body where the compiler moved a
statement of the body (a load, a store) to either side of the branch that
guards it. Back edges are cut, so the path crosses each loop body once, and
a loop unrolled ``u`` times carries ``u`` bodies (the site's unroll factor
divides them out). Instructions with a guard predicate are counted as
issued but not as operations. So the count is a lower bound for the work a
run of the region does once it reaches its main code: each branch on its
path takes its cheaper arm, as ``tpow`` does for an exponent of 1 whatever
the parameter is. Two things count more than runs: loop-invariant code the
compiler hoisted out of a counted loop counts once per iteration, and the
arm that holds the largest block is taken where another arm is cheaper.
The CUDA math
library's out-of-line slow paths (of IEEE division, reciprocal and square
root, under ``$__internal_..._slowpath`` labels) and instructions with no
source line inside a region are reported apart and not counted.

Each instruction counts as issued, and as float32 operations (an FFMA two,
other float32 arithmetic, compares and selects one), float64 operations (a
DFMA two, other float64 arithmetic and compares one) or special-function
operations (``MUFU``), which run on units of their own rate.

Nothing here needs a GPU except :func:`disassemble`, which runs the CUDA
toolkit's ``cuobjdump`` and ``nvdisasm``.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

__all__ = ["Instr", "Site", "Tally", "attribute", "block_at",
           "call_site_tally",
           "disassemble", "dynamic_count", "function_block", "least_paths",
           "parse_sass", "probe_sites", "region_names", "region_tallies"]


class Site(NamedTuple):
    """A counted region: the lines of its brace block (1-based, inclusive)
    and the unroll factor of the loop it counts."""

    start: int
    end: int
    unroll: int


class Instr(NamedTuple):
    """One SASS instruction: its function, opcode, inline chain of
    ``(file name, line)`` pairs (innermost first), the subroutine label it
    sits under ("" for the function's own body), whether it has a guard
    predicate, the block label it branches to ("" if none) and the block
    labels that point at it."""

    function: str
    opcode: str
    chain: tuple
    subroutine: str = ""
    predicated: bool = False
    target: str = ""
    labels: tuple = ()

    @property
    def slow_path(self) -> bool:
        """Under one of the CUDA math library's out-of-line slow paths."""
        return self.subroutine.startswith("$__internal")


@dataclass(frozen=True)
class Tally:
    """Instructions issued, float32 operations, special-function operations
    and float64 operations."""

    issued: float = 0.0
    flops: float = 0.0
    mufu: float = 0.0
    fp64: float = 0.0

    def __add__(self, other: "Tally") -> "Tally":
        return Tally(self.issued + other.issued, self.flops + other.flops,
                     self.mufu + other.mufu, self.fp64 + other.fp64)

    def scale(self, k: float) -> "Tally":
        return Tally(self.issued * k, self.flops * k, self.mufu * k,
                     self.fp64 * k)


# float32 arithmetic, compares and selects of the FMA pipes (an FFMA is two
# operations); conversions and half-precision moves are not counted
_FP32 = {"FADD", "FMUL", "FMNMX", "FSETP", "FSET", "FSEL", "FRND", "FCHK",
         "FSWZADD"}
# float64 arithmetic and compares of the FP64 pipe (a DFMA is two
# operations); the float64 builds have no MUFU exp or log: those are DFMA
# sequences, seeded by MUFU.RCP64H / MUFU.RSQ64H for division and sqrt
_FP64 = {"DADD", "DMUL", "DMNMX", "DSETP", "DSET"}


def _tally(ins: Instr) -> Tally:
    base = ins.opcode.split(".")[0]
    if ins.predicated:
        return Tally(1.0)
    flops = 2.0 if base == "FFMA" else 1.0 if base in _FP32 else 0.0
    fp64 = 2.0 if base == "DFMA" else 1.0 if base in _FP64 else 0.0
    return Tally(1.0, flops, 1.0 if base == "MUFU" else 0.0, fp64)


_SITE = re.compile(r"\bK5_COUNT\((\w+)(?:\s*,\s*(\w+))?\)")


def region_names(source: str) -> list:
    """The names of ``enum ProbeRegion`` in index order (without R_COUNT)."""
    body = re.search(r"enum\s+ProbeRegion\s*\{(.*?)\}", source, re.S)
    if body is None:
        raise ValueError("no enum ProbeRegion in the source")
    names = [n.strip() for n in re.sub(r"//[^\n]*", "", body.group(1))
             .split(",") if n.strip()]
    return [n for n in names if n != "R_COUNT"]


def _brace_blocks(source: str) -> list:
    """(open line, close line) of every brace pair, comments skipped."""
    blocks, stack = [], []
    for lineno, line in enumerate(source.splitlines(), 1):
        code = line.split("//", 1)[0]
        for ch in code:
            if ch == "{":
                stack.append(lineno)
            elif ch == "}":
                if not stack:
                    raise ValueError(f"unbalanced '}}' at line {lineno}")
                blocks.append((stack.pop(), lineno))
    if stack:
        raise ValueError(f"unbalanced '{{' at line {stack[-1]}")
    return blocks


def probe_sites(source: str, unrolls=None) -> dict:
    """Region name -> :class:`Site` for every K5_COUNT in ``source`` (the
    macro's own definition excluded); each region has one site. An unroll
    factor named by a constant takes its value from ``unrolls`` (a dict of
    the build's constants); a name missing there raises ``ValueError``."""
    unrolls = unrolls or {}
    blocks = _brace_blocks(source)
    sites = {}
    for lineno, line in enumerate(source.splitlines(), 1):
        code = line.split("//", 1)[0]
        if "#define" in code:
            continue
        for m in _SITE.finditer(code):
            name = m.group(1)
            if name in sites:
                raise ValueError(f"region {name} has two K5_COUNT sites")
            inner = [b for b in blocks if b[0] <= lineno <= b[1]]
            if not inner:
                raise ValueError(f"K5_COUNT({name}) outside any block")
            start, end = max(inner, key=lambda b: b[0])
            factor = m.group(2) or "1"
            if not factor.isdigit():
                if factor not in unrolls:
                    raise ValueError(f"K5_COUNT({name}): no value given for "
                                     f"the unroll factor {factor}")
                factor = unrolls[factor]
            sites[name] = Site(start, end, int(factor))
    return sites


def function_block(source: str, name: str) -> Site:
    """The body of the first function defined as ``name(`` in ``source``
    (its first brace block from the definition's line on), as a
    :class:`Site` of unroll 1."""
    lines = source.splitlines()
    at = next((i for i, line in enumerate(lines, 1)
               if re.search(rf"\b{re.escape(name)}\(", line.split("//")[0])
               and not line.split("//")[0].rstrip().endswith(";")), None)
    if at is None:
        raise ValueError(f"no definition of {name} in the source")
    start, end = min((b for b in _brace_blocks(source) if b[0] >= at),
                     key=lambda b: b[0])
    return Site(start, end, 1)


def block_at(source: str, text: str) -> Site:
    """The brace block that opens on the first line of ``source`` holding
    ``text`` (a loop of a function, counted apart from it), as a
    :class:`Site` of unroll 1."""
    at = next((i for i, line in enumerate(source.splitlines(), 1)
               if text in line.split("//")[0]), None)
    if at is None:
        raise ValueError(f"no line of the source holds {text!r}")
    opening = [b for b in _brace_blocks(source) if b[0] == at]
    if not opening:
        raise ValueError(f"no brace block opens on line {at}")
    start, end = max(opening, key=lambda b: b[1] - b[0])
    return Site(start, end, 1)


_FUNC = re.compile(r"^\s*\.text\.([\w.$@]+):\s*$|^\s*Function\s*:\s*(\S+)")
_BLOCK = re.compile(r"^\s*(\.L\w*):\s*$")
_LABEL = re.compile(r"^\s*([^\s/.][^\s]*):\s*$")
_LOC = re.compile(r'"([^"]+)"\s*,\s*line\s+(\d+)')
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(?:\{\s*)?(.*?)\s*;")
_TARGET = re.compile(r"`\((\.L\w*)\)")


def parse_sass(text: str) -> list:
    """The instructions of ``nvdisasm -g[i]`` (or ``cuobjdump -sass``)
    output, each with its function, the inline chain of the line markers
    before it (empty without one), its guard, branch target and block
    labels. ``nvdisasm -gi`` prints one ``//##`` line per inline level,
    innermost first (``File "a", line 1 inlined at "b", line 2``, then
    ``File "b", line 2 inlined at ...``, down to the outermost ``File "c",
    line 3``). NOPs are dropped (a label on one moves to the next
    instruction)."""
    out, func, chain, in_marker, sub, labels = [], "", (), False, "", []
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            func, chain, in_marker, sub = m.group(1) or m.group(2), (), False, ""
            labels = []
            continue
        m = _BLOCK.match(line)
        if m and func:
            labels.append(m.group(1))
            continue
        m = _LABEL.match(line)
        if m and func:
            # a function or subroutine label
            sub = "" if func.endswith(m.group(1)) else m.group(1)
            continue
        if "//##" in line:
            locs = tuple((Path(f).name, int(n))
                         for f, n in _LOC.findall(line))
            if in_marker and chain and locs and locs[0] == chain[-1]:
                locs = locs[1:]
            chain = (chain if in_marker else ()) + locs
            in_marker = True
            continue
        in_marker = False
        m = _INSTR.search(line)
        if m and func:
            tokens = m.group(1).split()
            guarded = bool(tokens) and tokens[0].startswith("@")
            if guarded:
                tokens = tokens[1:]
            if tokens and tokens[0] != "NOP":
                target = _TARGET.search(m.group(1))
                out.append(Instr(func, tokens[0], chain, sub, guarded,
                                 target.group(1) if target else "",
                                 tuple(labels)))
                labels = []
    return out


def attribute(instrs, sites: dict, source_name: str) -> tuple:
    """Per instruction, its ``(region, copy)`` or None, the copy being the
    call path outside the region that it was inlined through (one per
    inlined call site); and the number of instructions with no line of
    ``source_name`` inside a region or under a slow-path subroutine."""
    spans = sorted(((s.start, s.end, name) for name, s in sites.items()),
                   key=lambda t: t[1] - t[0])    # innermost first
    groups, lost = [], 0
    for ins in instrs:
        group = None
        if not ins.slow_path:
            for k, (fname, line) in enumerate(ins.chain):
                if fname != source_name:
                    continue
                region = next((n for a, b, n in spans if a <= line <= b),
                              None)
                if region is not None:
                    group = (region, (ins.function, ins.subroutine)
                             + ins.chain[k + 1:])
                    break
        groups.append(group)
        lost += group is None
    return groups, lost


_ENDS_BLOCK = {"BRA", "JMP", "BRX", "JMX", "EXIT", "RET"}


def _cfg(body) -> tuple:
    """Block of each instruction of one function's own code (in address
    order) and each block's successors, back edges cut: a branch back to
    an earlier block leaves the loop after one pass instead."""
    n = len(body)
    pos = {lab: j for j, ins in enumerate(body) for lab in ins.labels}
    leaders = {0}
    for j, ins in enumerate(body):
        if ins.labels:
            leaders.add(j)
        if ins.opcode.split(".")[0] in _ENDS_BLOCK and j + 1 < n:
            leaders.add(j + 1)
    starts = sorted(leaders)
    block_of = []
    for b, s in enumerate(starts):
        block_of += [b] * ((starts[b + 1] if b + 1 < len(starts) else n) - s)
    succ = []
    for b in range(len(starts)):
        last = body[(starts[b + 1] if b + 1 < len(starts) else n) - 1]
        nxt = {b + 1} if b + 1 < len(starts) else set()
        base = last.opcode.split(".")[0]
        if base in ("BRA", "JMP"):
            t = pos.get(last.target)
            out = (({block_of[t]} if block_of[t] > b else nxt)
                   if t is not None else set())
            if last.predicated:
                out |= nxt
        elif base in ("EXIT", "RET"):
            out = nxt if last.predicated else set()
        else:
            out = nxt
        succ.append(sorted(out))
    return block_of, succ


def _least_path(succ, cost: dict, src: int, dst: int):
    """The blocks of the path from ``src`` to ``dst`` with the least total
    ``cost`` (blocks are in topological order), or None if there is
    none."""
    dist, prev = {src: cost.get(src, 0)}, {}
    for b in range(src, dst):
        if b not in dist:
            continue
        for s in succ[b]:
            d = dist[b] + cost.get(s, 0)
            if s <= dst and d < dist.get(s, float("inf")):
                dist[s], prev[s] = d, b
    if dst not in dist:
        return None
    path, b = {dst}, dst
    while b != src:
        b = prev[b]
        path.add(b)
    return path


def least_paths(instrs, groups) -> list:
    """Per instruction, whether it lies on the least path of its group
    (the path from the group's first instruction through the block that
    holds most of them to its last, in the code of its function or called
    subroutine, that runs the fewest of the group's instructions). A group
    with no such path keeps every instruction."""
    on = [False] * len(instrs)
    bodies = {}
    for k, ins in enumerate(instrs):
        if not ins.slow_path:
            bodies.setdefault((ins.function, ins.subroutine), []).append(k)
    for idx in bodies.values():
        block_of, succ = _cfg([instrs[k] for k in idx])
        members = {}
        for j, k in enumerate(idx):
            if groups[k] is not None:
                members.setdefault(groups[k], []).append(j)
        for js in members.values():
            cost = {}
            for j in js:
                cost[block_of[j]] = cost.get(block_of[j], 0) + 1
            core = max(cost, key=lambda b: (cost[b], -b))
            head = _least_path(succ, cost, block_of[js[0]], core)
            tail = _least_path(succ, cost, core, block_of[js[-1]])
            path = None if head is None or tail is None else head | tail
            for j in js:
                on[idx[j]] = path is None or block_of[j] in path
    return on


def region_tallies(instrs, sites: dict, source_name: str) -> tuple:
    """Per region, the :class:`Tally` of one run of a copy on its least
    path (the mean over its copies), the instructions of a copy in the
    SASS (every arm), and its copies; and the instructions in no
    region."""
    groups, lost = attribute(instrs, sites, source_name)
    on = least_paths(instrs, groups)
    per = {name: Tally() for name in sites}
    static = dict.fromkeys(sites, 0)
    copies = {name: set() for name in sites}
    for ins, group, kept in zip(instrs, groups, on):
        if group is None:
            continue
        region, copy = group
        copies[region].add(copy)
        static[region] += 1
        if kept:
            per[region] = per[region] + _tally(ins)
    n = {name: max(1, len(c)) for name, c in copies.items()}
    return ({name: t.scale(1.0 / n[name]) for name, t in per.items()},
            {name: static[name] / n[name] for name in sites}, n, lost)


def call_site_tally(instrs, sites: dict, source_name: str,
                    region: str) -> tuple:
    """For a region with one call site, run once per call (K1-K4's
    ``cell_step``, once per cell): the :class:`Tally` of one run along the
    least path of its largest copy, and that copy's instructions (every
    arm). Code the compiler hoisted out of the call loses the call site's
    line from its inline chain and so forms a small copy of its own that
    does not run per call: the copies are not averaged, as
    :func:`region_tallies` averages the copies of a region inlined at
    several sites."""
    groups, _ = attribute(instrs, sites, source_name)
    copies = {}
    for ins, group, kept in zip(instrs, groups, least_paths(instrs, groups)):
        if group is not None and group[0] == region:
            copies.setdefault(group[1], []).append((ins, kept))
    if not copies:
        raise ValueError(f"no instruction of region {region}")
    main = max(copies.values(), key=len)
    tally = sum((_tally(ins) for ins, kept in main if kept), Tally())
    return tally, len(main)


def dynamic_count(per_region: dict, counts: dict, sites: dict) -> dict:
    """Region -> :class:`Tally` run: one run of a copy times the region's
    executions over the unroll factor of its loop."""
    return {name: per_region[name].scale(counts.get(name, 0)
                                         / sites[name].unroll)
            for name in sites}


def _tool(name: str) -> str:
    """The CUDA toolkit's ``name`` (beside nvcc, on PATH, or the copy
    Triton's package carries)."""
    from ._build import nvcc_path

    path = Path(nvcc_path()).parent / name
    if path.is_file():
        return str(path)
    found = shutil.which(name)
    if found:
        return found
    try:
        import triton

        bundled = (Path(triton.__file__).parent / "backends" / "nvidia"
                   / "bin" / name)
        if bundled.is_file():
            return str(bundled)
    except ImportError:
        pass
    raise RuntimeError(f"{name} not found beside nvcc, on PATH or in "
                       f"Triton's package")


def disassemble(library: Path) -> str:
    """The SASS of every cubin in ``library`` with its line table and
    inline chains (``nvdisasm -c -g -gi``)."""
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([_tool("cuobjdump"), "-xelf", "all",
                        str(Path(library).resolve())], cwd=tmp, check=True,
                       capture_output=True, timeout=120)
        texts = []
        for cubin in sorted(Path(tmp).glob("*.cubin")):
            proc = subprocess.run(
                [_tool("nvdisasm"), "-c", "-g", "-gi", str(cubin)],
                capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"nvdisasm failed: {proc.stderr.strip()}")
            texts.append(proc.stdout)
        if not texts:
            raise RuntimeError(f"no cubin in {library}")
        return "\n".join(texts)
