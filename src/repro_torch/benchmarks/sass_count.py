"""SASS instructions an element of K1 and the hash kernels, counted from the
compiled code of one or more trees of this repository:

    python -m repro_torch.benchmarks.sass_count --trees build/parent,. \\
        --out build/sass_count.json [--dump build/sass]

Each tree's ``csrc/analog_update.cu`` and ``csrc/fastrng.cu`` are built by
that tree's own ``kernels/cuda_build.py`` (one subprocess a tree), and
``cuobjdump`` disassembles the libraries (``-sass``) and reads each
kernel's registers (``-res-usage``). Needs ``nvcc`` and ``cuobjdump``,
not a card.

What is counted: the element loop's hot path. In each kernel the loop
that holds the widest global store is taken (the vector path where there
is one); the path from its head to its back edge that passes through
every such store and, elsewhere, takes the shortest way (the branch not
taken by the common case: the slow path of an IEEE division or square
root, the erfinv tail, the range fallback of a division by a launch
scalar are longer) is counted instruction by instruction, by class, and
divided by the elements its stores write. Both polynomials of the erfinv
are off that path only where the compiler branches around them. Static
totals of the whole kernel are kept beside it.

``issue_us(per_element, elements, sm_clock_mhz)`` is the issue bound: the
card issues at most one warp instruction a clock on each of its 4 x 132
schedulers, 132 x 128 thread-instructions a clock.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, List, Optional

H100_SMS = 132
THREAD_ISSUE_PER_SM_CLOCK = 128   # 4 schedulers x one warp instruction

CLASSES = ("fp32", "int", "cvt_mufu", "mem", "ctrl")
_FP32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK",
         "FADD32I", "FMUL32I", "FFMA32I", "FSWZADD"}
_CVT = {"I2F", "I2FP", "F2I", "F2F", "FRND", "F2FP", "MUFU", "I2I", "F2IP"}
_MEM_PREFIX = ("LDG", "STG", "LDS", "STS", "LDC", "ULDC", "LDL", "STL",
               "LD", "ST", "ATOM", "RED", "LDSM", "UBLKCP", "UTMALDG")
_CTRL = {"BRA", "BRX", "EXIT", "RET", "CALL", "BSSY", "BSYNC", "WARPSYNC",
         "BAR", "NOP", "YIELD", "BMOV", "JMP", "KILL", "BPT", "ACQBULK"}

_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


def classify(op: str) -> str:
    base = op.split(".")[0]
    if base in _FP32:
        return "fp32"
    if base in _CVT:
        return "cvt_mufu"
    if base in _CTRL:
        return "ctrl"
    if base.startswith(_MEM_PREFIX):
        return "mem"
    return "int"


def store_bytes(op: str) -> int:
    """Bytes one thread stores with global store ``op`` (0: not one)."""
    if not op.startswith("STG"):
        return 0
    for tag, n in ((".128", 16), (".64", 8), (".U16", 2), (".S16", 2),
                   (".U8", 1), (".S8", 1)):
        if tag in op:
            return n
    return 4


def parse_sass(text: str) -> Dict[str, List[dict]]:
    """{mangled kernel name: [instruction, ...]} from ``cuobjdump -sass``;
    an instruction is {addr, pred, op, args, label_target}."""
    funcs: Dict[str, List[dict]] = {}
    labels: Dict[str, Dict[str, int]] = {}
    cur = None
    pending: List[str] = []
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            labels[cur] = {}
            pending = []
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        body = m.group(2)
        pred = ""
        if body.startswith("@"):
            pred, body = body.split(None, 1)
        parts = body.split(None, 1)
        op = parts[0]
        args = parts[1] if len(parts) > 1 else ""
        for lab in pending:
            labels[cur][lab] = addr
        pending = []
        funcs[cur].append(dict(addr=addr, pred=pred, op=op, args=args))
    for name, ins in funcs.items():
        for i in ins:
            i["target"] = None
            if i["op"].split(".")[0] in ("BRA", "CALL", "BSSY"):
                m = _TARGET.search(i["args"])
                if m:
                    i["target"] = (labels[name].get(m.group(1))
                                   if m.group(1) else int(m.group(2), 16))
    return funcs


def _succ(ins: List[dict], k: int, index: Dict[int, int]) -> List[int]:
    i = ins[k]
    base = i["op"].split(".")[0]
    always = i["pred"] in ("", "@PT")
    out = []
    if base == "BRA" and i["target"] is not None:
        out.append(index[i["target"]])
        if not always and k + 1 < len(ins):
            out.append(k + 1)
        return out
    if base in ("EXIT", "RET", "BRX", "JMP", "KILL") and always:
        return out
    return [k + 1] if k + 1 < len(ins) else []


def hot_path(ins: List[dict]) -> Optional[dict]:
    """The element loop's counted path (see the module's docstring)."""
    index = {i["addr"]: k for k, i in enumerate(ins)}
    widest = max((store_bytes(i["op"]) for i in ins), default=0)
    if not widest:
        return None
    # loops: back edges k -> head (head <= k)
    loops = [(index[i["target"]], k) for k, i in enumerate(ins)
             if i["op"].startswith("BRA") and i["target"] is not None
             and i["target"] <= i["addr"]]
    best = None
    for head, latch in loops:
        stores = [k for k in range(head, latch + 1)
                  if store_bytes(ins[k]["op"]) == widest]
        if stores and (best is None or latch - head < best[1] - best[0]):
            best = (head, latch, stores)
    if best is None:       # no loop: the kernel's one pass from its entry
        stores = [k for k, i in enumerate(ins)
                  if store_bytes(i["op"]) == widest]
        exits = [k for k, i in enumerate(ins)
                 if i["op"].startswith("EXIT") and k > stores[-1]]
        best = (0, exits[0], stores)
    head, latch, stores = best
    path = [head]
    for a, b in zip([head] + stores, stores + [latch]):
        seg = _shortest(ins, index, a, b, head, latch)
        if seg is None:
            return None
        path += seg[1:]
    counts = dict.fromkeys(CLASSES, 0)
    stored = 0
    for k in path:
        counts[classify(ins[k]["op"])] += 1
        stored += store_bytes(ins[k]["op"])
    return dict(instructions=len(path), stored_bytes=stored, by_class=counts,
                loop=[ins[head]["addr"], ins[latch]["addr"]])


def _shortest(ins, index, a: int, b: int, lo: int, hi: int):
    """Fewest instructions from ``a`` to ``b`` inside [lo, hi], forward
    edges only (the loop's back edges cut)."""
    if a == b:
        return [a]
    dist = {a: 1}
    prev = {}
    for k in range(a, hi + 1):
        if k not in dist:
            continue
        if k == b:
            break
        for s in _succ(ins, k, index):
            if s <= k or s > hi or s < lo:
                continue
            if s not in dist or dist[k] + 1 < dist[s]:
                dist[s] = dist[k] + 1
                prev[s] = k
    if b not in dist:
        return None
    out = [b]
    while out[-1] != a:
        out.append(prev[out[-1]])
    return out[::-1]


def _idents(mangled: str):
    """(identifiers, the rest) of an Itanium-mangled name."""
    s = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    names = []
    while s and s[0].isdigit():
        m = re.match(r"(\d+)", s)
        n = int(m.group(1))
        s = s[len(m.group(1)):]
        names.append(s[:n])
        s = s[n:]
    return names, s


def _targs(rest: str) -> List[str]:
    out = []
    if not rest.startswith("I"):
        return out
    s = rest[1:]
    named = None
    while s and s[0] != "E":
        if s[0] == "f":
            out.append("float")
            s = s[1:]
        elif s.startswith("Lb"):
            out.append(s[2])
            s = s[4:]
        elif s[0].isdigit():
            m = re.match(r"(\d+)", s)
            n = int(m.group(1))
            named = s[len(m.group(1)):len(m.group(1)) + n]
            out.append(named)
            s = s[len(m.group(1)) + n:]
        elif s[0] == "S" and named:   # a substitution: the type named last
            s = s[s.index("_") + 1:]
            out.append(named)
        else:
            break
    return out


_DEVICE_CONFIGS = {("1", "1"): "dev_p", ("1", "0"): "dev_w",
                   ("0", "0"): "no_d2d", ("0", "1"): "target_only"}


def kernel_label(mangled: str) -> Optional[str]:
    """A readable label of the kernels counted here, None for the others."""
    names, rest = _idents(mangled)
    if not names:
        return None
    name, args = names[-1], _targs(rest)
    short = {"float": "f32", "__nv_bfloat16": "bf16"}
    if name.startswith("analog_update") and name.endswith("_kernel"):
        w = short.get(args[0], args[0]) if args else "?"
        d = short.get(args[1], args[1]) if len(args) > 1 else "?"
        if len(args) > 2 and args[2] == "1":   # one kernel of both modes
            name = name.replace("analog_update", "analog_update_hash")
        return f"{name[:-7]}<w {w}, dw {d}>"
    if name == "hash_normal_kernel":
        return "hash_normal"
    if name == "hash_device_kernel" and len(args) == 2:
        return f"hash_device<{_DEVICE_CONFIGS[tuple(args)]}>"
    return None


def out_bytes(label: str) -> int:
    """Bytes stored an element by the kernel of ``label``."""
    if label.startswith("hash_device"):
        return 8
    if label.startswith("analog_update"):
        return 2 if "<w bf16" in label else 4
    return 4


def registers(path: str, tool: str) -> Dict[str, int]:
    text = subprocess.run([tool, "-res-usage", path], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"^\s*Function\s*:?\s*(\S+?):?\s*$", line)
        if m:
            cur = m.group(1)
        m = re.search(r"REG:(\d+)", line)
        if m and cur:
            out[cur] = int(m.group(1))
            cur = None
    return out


def cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "cuobjdump"),
                 shutil.which("cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    try:
        import triton
        cand = os.path.join(os.path.dirname(triton.__file__), "backends",
                            "nvidia", "bin", "cuobjdump")
        if os.path.exists(cand):
            return cand
    except ImportError:
        pass
    raise RuntimeError("cuobjdump not found (set CUDA_HOME)")


def count_library(path: str, dump: Optional[str] = None) -> Dict[str, dict]:
    """{kernel label: counts} of one built library (``.so`` or cubin)."""
    tool = cuobjdump()
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    if dump:
        with open(dump, "w") as f:
            f.write(text)
    regs = registers(path, tool)
    out = {}
    for name, ins in parse_sass(text).items():
        label = kernel_label(name)
        if label is None:
            continue
        static = dict.fromkeys(CLASSES, 0)
        for i in ins:
            static[classify(i["op"])] += 1
        hot = hot_path(ins)
        entry = dict(mangled=name, registers=regs.get(name),
                     static=sum(static.values()), static_by_class=static)
        if hot:
            elems = hot["stored_bytes"] / out_bytes(label)
            entry.update(
                path_instructions=hot["instructions"], path_elements=elems,
                per_element=hot["instructions"] / elems,
                per_element_by_class={k: v / elems
                                      for k, v in hot["by_class"].items()},
                loop=hot["loop"])
        out[label] = entry
    return out


def issue_us(per_element: float, elements: int, sm_clock_mhz: float,
             sms: int = H100_SMS) -> float:
    """The issue bound in us: ``per_element * elements`` thread-instructions
    at 128 a clock on each of ``sms`` SMs."""
    return (per_element * elements
            / (sms * THREAD_ISSUE_PER_SM_CLOCK * sm_clock_mhz * 1e6) * 1e6)


def build_tree(tree: str) -> Dict[str, str]:
    """The tree's two libraries, built by its own ``cuda_build``."""
    code = ("import json\nfrom repro_torch.kernels import cuda_build\n"
            "print(json.dumps({k: str(v) for k, v in cuda_build.build("
            "['analog_update', 'fastrng']).items()}))")
    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
    p = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env,
                       capture_output=True, text=True, check=True)
    return json.loads(p.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", default=".",
                    help="comma-separated checkouts, e.g. build/parent,.")
    ap.add_argument("--out", default="build/sass_count.json")
    ap.add_argument("--dump", help="directory for each library's SASS")
    args = ap.parse_args(argv)
    res = {}
    for t, tree in enumerate(args.trees.split(",")):
        tree = os.path.abspath(tree)
        libs = build_tree(tree)
        res[tree] = {}
        for name, path in libs.items():
            dump = None
            if args.dump:
                os.makedirs(args.dump, exist_ok=True)
                dump = os.path.join(args.dump, f"tree{t}_{name}.sass")
            res[tree].update(count_library(path, dump))
        for label, e in sorted(res[tree].items()):
            by = e.get("per_element_by_class", {})
            print(f"sass: tree{t} {label}: {e.get('per_element', 0):.2f} "
                  f"instructions an element ("
                  + ", ".join(f"{k} {v:.2f}" for k, v in by.items())
                  + f"), {e['registers']} registers, {e['static']} static")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
