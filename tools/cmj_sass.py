"""The SASS the port's kernels compile to, counted for their bounds.

Builds the kernel library (``utils/cuda_lib.build``), disassembles it with
``cuobjdump -sass`` and prints, for each kernel named (by default the
sample streams' kernel of ``csrc/cmj.cu``, the draw set's
``cmj_draws_kernel``), one JSON line per compiled function: its
instruction count by opcode, every loop (a branch back to an earlier
address) with the instructions between its head and that branch, and its
basic blocks. The draw set's bound counts its own arithmetic in the
listing ``--out`` writes (``chip_smoke.py``'s ``DRAWS_OPS``, with the
addresses of the build of ``csrc/cmj.cu`` as it stands: a hash operand,
a seed's salt products, a permutation round, the magic divisions, a
rand_float, an IEEE division, a store), leaving out plan decoding, loop
control and addressing.
``--kernels build_items_kernel`` lists the single-pass item-list kernel
(its bound is bytes).
``--kernels cluster_pipeline_kernel`` gives the pipeline's slab-test and
triangle-test loops (``chip_smoke.py``'s ``PIPE_INSNS``), ``--kernels
fold_small_kernel`` the tiny-mesh fold's (``FOLD_INSNS``); for those two
each loop also counts its ``float_loads``: float instructions (arithmetic,
compares, selects, ``MUFU`` and the division's ``FCHK``) and loads from
shared or global memory, leaving out integer, address and control work.
The whole listing is written to ``--out``. ``--walk START:STOP[:A=t,B=n]``
counts the instructions a lane issues from address START up to STOP (not
included) in the first kernel named: a predicated forward branch is taken
and a backward one is not (no loop repeats), unless listed as taken
(``t``) or not (``n``); an unpredicated branch is followed: every
instruction the kernel issues on that path, its overhead included (the
same build: the lane set-up ``0:480:100=t,250=t,380=t``, a seed
``480:1270`` with its operand selects set per operand kind, a 2-D draw
``1270:3270:1320=n``, a 1-D draw ``1270:3270:1320=t``, the seed loop's
tail and the exit ``3270:32c0``).

    python3 tools/cmj_sass.py --out build/cmj_sass.txt
    python3 tools/cmj_sass.py --kernels cluster_pipeline_kernel,fold_small_kernel
    python3 tools/cmj_sass.py --kernels cmj_draws_kernel --walk 1270:3270:1320=n

Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit); no card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KERNELS = ("cmj_draws_kernel",)
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"(0x[0-9a-f]+|\.L_x_\d+)")
# opcodes that end a basic block
_ENDS = ("BRA", "EXIT", "CALL", "RET", "BSSY", "BSYNC")
# a test's float work and its data's loads (FENCE is not a float op)
_FLOAT_LOADS = ("F", "MUFU", "LDS", "LDG")


def _float_loads(ops: dict) -> int:
    return sum(n for op, n in ops.items()
               if op.startswith(_FLOAT_LOADS) and not op.startswith("FENCE"))


def _functions(sass: str) -> dict:
    """{function name: its lines} of a cuobjdump -sass listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def _parse(lines):
    """[(address, opcode, operands)] and {label: address}."""
    insns, labels, pending = [], {}, []
    for line in lines:
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            insns.append((addr, m.group(3), m.group(4).strip()))
    return insns, labels


def _histogram(insns) -> dict:
    return dict(collections.Counter(op for _, op, _ in insns).most_common())


def _target(args, labels):
    m = _TARGET.search(args)
    if not m:
        return None
    tgt = m.group(1)
    return labels.get(tgt) if tgt.startswith(".L") else int(tgt, 16)


def summarize(lines) -> dict:
    """Opcode counts of one function and of each of its loops, and its
    basic blocks ("start: instructions, last opcode"): the instructions a
    lane issues are the sum of the blocks on its path."""
    insns, labels = _parse(lines)
    insns = [i for i in insns if i[1] != "NOP"]
    loops, starts = [], {insns[0][0]}
    for k, (addr, op, args) in enumerate(insns):
        if op.startswith(_ENDS) and k + 1 < len(insns):
            starts.add(insns[k + 1][0])
        if not op.startswith(("BRA", "CALL")):
            continue
        tgt = _target(args, labels)
        if tgt is None:
            continue
        starts.add(tgt)
        if op.startswith("BRA") and tgt < addr:
            body = [i for i in insns if tgt <= i[0] <= addr]
            ops = _histogram(body)
            loops.append({"head": hex(tgt), "branch": hex(addr),
                          "insns": len(body), "float_loads": _float_loads(ops),
                          "ops": ops})
    blocks = []
    for addr, op, _ in insns:
        if addr in starts:
            blocks.append([addr, 0, op])
        blocks[-1][1:] = [blocks[-1][1] + 1, op]
    return {"insns": len(insns), "ops": _histogram(insns), "loops": loops,
            "blocks": [f"{a:#06x}: {n}, {op}" for a, n, op in blocks]}


def walk(lines, spec: str) -> dict:
    """Instructions on the path ``START:STOP[:A=t,B=n]`` (hex addresses)
    of one function's listing, and the branches it took."""
    parts = spec.split(":")
    start, stop = int(parts[0], 16), int(parts[1], 16)
    decide = {}
    if len(parts) > 2 and parts[2]:
        for item in parts[2].split(","):
            addr, how = item.split("=")
            decide[int(addr, 16)] = how == "t"
    insns, labels = _parse(lines)
    at = {addr: k for k, (addr, _, _) in enumerate(insns)}
    preds = {}
    for line in lines:
        m = _INSN.search(line)
        if m:
            preds[int(m.group(1), 16)] = bool(m.group(2))
    k, count, taken = at[start], 0, []
    while insns[k][0] != stop:
        addr, op, args = insns[k]
        if count > 100_000:
            raise RuntimeError(f"walk {spec}: no end")
        count += op != "NOP"
        if op.startswith("EXIT") and not preds[addr]:
            break
        if op.startswith("BRA"):
            tgt = _target(args, labels)
            conditional = preds[addr] or args.startswith(("P", "!P"))
            if not conditional or decide.get(addr, tgt > addr):
                taken.append(f"{addr:#x}->{tgt:#x}")
                k = at[tgt]
                continue
        k += 1
    return {"walk": spec, "insns": count, "taken": taken}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="file for the whole listing of the kernels")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated kernel names (symbol substrings)")
    ap.add_argument("--walk", action="append", default=[],
                    help="START:STOP[:ADDR=t|n,...] path to count in the "
                         "first kernel named (hex addresses)")
    args = ap.parse_args()
    kernels = tuple(args.kernels.split(","))

    from rayito_tpu_torch.utils import cuda_lib

    cuda_lib.build()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", cuda_lib.LIB_PATH], check=True,
                          capture_output=True, text=True).stdout
    funcs = {name: lines for name, lines in _functions(sass).items()
             if any(k in name for k in kernels)}
    missing = [k for k in kernels if not any(k in n for n in funcs)]
    if missing:
        print(f"{missing} not found in {cuda_lib.LIB_PATH}", file=sys.stderr)
        return 1
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for name, lines in funcs.items():
                f.write(f"Function : {name}\n" + "\n".join(lines) + "\n")
    for name, lines in funcs.items():
        kernel = next(k for k in kernels if k in name)
        print(json.dumps({"kernel": kernel, "symbol": name,
                          **summarize(lines)}))
    first = next(n for n in funcs if kernels[0] in n)
    for spec in args.walk:
        print(json.dumps({"kernel": kernels[0], **walk(funcs[first], spec)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
