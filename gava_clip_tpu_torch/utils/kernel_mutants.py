"""Show that the on-card checks reject a kernel with a moved rounding point
or a wrong bound: build deliberately broken copies of a kernel source and
run the check phase of chip_smoke.py on each.

    python3 -m gava_clip_tpu_torch.utils.kernel_mutants      # from the repo root, on a card

Each mutant is a copy of the package and of chip_smoke.py under
`_scratch/mut_<name>/` (gitignored) with one source patched; the copy
builds into its own `_build/`, so the real build is never touched. A
mutant is rejected when its phase raises; the lines of the kernel under
test are printed. The script exits 1 if a mutant passes.
"""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_B8 = "gava_clip_tpu_torch/csrc/packed_attention_bwd_recompute.cu"
_B12 = "gava_clip_tpu_torch/csrc/attention_out_int8.cu"
_ROUND = "__bfloat162float(__float2bfloat16({}))"
# name -> (source, [(old, new)], chip_smoke phase, word that marks the
# kernel's lines)
MUTANTS = {
    # the rebuilt output rounded to bf16 before delta, as the
    # saved-residual backward reads it
    "b8_o_rounded": (
        _B8, [(f"(n[{i}] * inv{i // 2})",
               _ROUND.format(f"n[{i}] * inv{i // 2}")) for i in range(4)],
        "phase_train_kernels", "recompute"),
    # the denominator summed from the unrounded e
    "b8_den_unrounded": (
        _B8, [("        eb[i] = __float2bfloat16(key < a.Lk ? "
               "exp2f(fminf(s[n][i] * a.c, 110.f)) : 0.f);\n"
               "        rsum[i >> 1] += __bfloat162float(eb[i]);",
               "        const float ef = key < a.Lk ? "
               "exp2f(fminf(s[n][i] * a.c, 110.f)) : 0.f;\n"
               "        eb[i] = __float2bfloat16(ef);\n"
               "        rsum[i >> 1] += ef;")],
        "phase_train_kernels", "recompute"),
    # the second source one key short
    "b12_len_off_by_one": (
        _B12, [("B, Lq, L1 + L2, H, q_sb, q_sl,\n"
                "                              k1_sb",
                "B, Lq, L1 + L2 - 1, H, q_sb, q_sl,\n"
                "                              k1_sb"),
               ("B, Lq, L1 + L2, H, q_sb, q_sl,\n"
                "                             k1_sb",
                "B, Lq, L1 + L2 - 1, H, q_sb, q_sl,\n"
                "                             k1_sb")],
        "phase_w8a8_kernels", "2src"),
    # the second source's values read one row early
    "b12_second_source_row_shift": (
        _B12, [("return v2b + static_cast<long long>(j - s2.L1) * s2.v2_sl;",
                "return v2b + static_cast<long long>(j - s2.L1 > 0 ? "
                "j - s2.L1 - 1 : 0) * s2.v2_sl;")],
        "phase_w8a8_kernels", "2src"),
}


def main() -> int:
    passed = []
    for name, (path, edits, phase, word) in MUTANTS.items():
        d = os.path.join(ROOT, "_scratch", "mut_" + name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        shutil.copytree(os.path.join(ROOT, "gava_clip_tpu_torch"),
                        os.path.join(d, "gava_clip_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), d)
        with open(os.path.join(d, path)) as f:
            src = f.read()
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} occurs "
                                   f"{src.count(old)} times in {path}")
            src = src.replace(old, new)
        with open(os.path.join(d, path), "w") as f:
            f.write(src)
        code = ("import chip_smoke as cs\ncs.import_port()\nstate = {}\n"
                f"cs.phase_device(state)\ncs.{phase}(state)\n")
        res = subprocess.run([sys.executable, "-c", code], cwd=d,
                             capture_output=True, text=True)
        print(f"===== mutant {name}: exit code {res.returncode} "
              f"({'rejected' if res.returncode else 'PASSED'})", flush=True)
        for line in res.stdout.splitlines():
            if word in line or line.startswith("[device] nvidia-smi"):
                print("    " + line[:400], flush=True)
        if res.returncode == 0:
            passed.append(name)
    if passed:
        print(f"mutants that the checks did not reject: {passed}")
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
