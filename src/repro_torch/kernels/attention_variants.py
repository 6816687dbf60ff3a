"""Variant timings of the int8 attention kernel on the card.

Each variant is ``csrc/int8_attention.cu`` with named parts cut out or
changed by exact text edits (a variant whose text is no longer in the
source stops the run with the text it missed), built with the port's
flags into ``build/variants/`` (one ``nvcc`` each, all started together)
and launched through the port's own binding on starcoder2-3b's prefill
tile: batch 4 x 24 heads x 1024 x 128, G = 12, the sliding window
(4096 > S) and the reference's (128, 128) blocks.  V's K-major image is
made once, so a time is the kernel's alone.  Cut variants compute wrong
results: the time a cut removes is what that part cost.  ``general``
runs the mma kernel with every tile width a runtime value where the
launcher would pick the 128-wide one (not the dp4a instantiation of the
tiles past the mma ones).  With ``--check``
every variant is also held against ``attention_core_reference`` (``m``
and min/max/clip/n exact, the rest within the kernel tests' tolerances).
A name may repeat, to interleave runs of the same build.

    python3 -m repro_torch.kernels.attention_variants \\
        [--variants base,general,base,general] [--check] [--reps 20]

``file:PATH`` as a variant name builds the kernel source at PATH (a parent
checkout's ``csrc/int8_attention.cu``, with this checkout's headers):
``--variants base,file:P,file:P,base`` compares the two in turns.

It prints the card's name and power limit, each build's ptxas lines and
one line per run.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys

import torch

from repro_torch import configs
from repro_torch.kernels import build, tuning
from repro_torch.kernels import int8_attention as attn
from repro_torch.kernels import int8_matmul as mm

# name -> [(text, replacement)]; every text must occur in the source.
EDITS = {
    "general": [("  const bool fix = S.vec && hd == kMax && bkv == kMax && !tall;\n",
                 "  const bool fix = false;\n")],
    "no_qk": [("          tile_mma<kKs>(acc, qa[u], smem_addr(Kb) + 64 * h * L.ld, "
               "L.ld, nks,\n                        snt, lane);\n",
               "          ;\n")],
    "no_pv": [("        if (live && ont > 0)\n          tile_mma<4>(pacc, "
               "smem_addr(pw[u]), smem_addr(Vb) + 64 * h * kLd,",
               "        if (0)\n          tile_mma<4>(pacc, smem_addr(pw[u]), "
               "smem_addr(Vb) + 64 * h * kLd,")],
    "no_rowsums": [("      row_sums<kKs>(smem_addr(Kb), L.ld, nks, nnt, rowsum_k, w, "
                    "lane);\n", ""),
                   ("        row_sums<4>(smem_addr(Vb) + rb * kMax * kLd, kLd, pks, "
                    "hnt - 16 * rb,\n                    colsum_v + rb * kMax, w, "
                    "lane);\n", "        ;\n")],
    "no_tree": [("      tree_rows(te, ts, tree, w, h, lane);\n", ""),
                ("                                          int w, int lane) {\n",
                 "                                          int w, int lane) {\n"
                 "  return;\n"),
                ("                                           float& st_sig) {\n",
                 "                                           float& st_sig) {\n"
                 "  return;\n")],
    "no_exp": [("const float ex = expf(__fsub_rn(s[u][nt][e], m_new[u][r]));",
                "const float ex = __fsub_rn(s[u][nt][e], m_new[u][r]);")],
    "no_div": [("__fdiv_rn(p, scale_p)", "__fmul_rn(p, scale_p)")],
    "no_stage": [("      if (nk >= 0) stage_kv(nk, buf ^ 1);\n", "")],
    "no_stats": [("            const bool sv = kAll || (row_ok[u][r] && c < cvalid);",
                  "            const bool sv = false;")],
    "no_oupd": [("          for (int e = 0; e < 4; ++e)\n            o[u][nt][e] = "
                 "__fadd_rn(__fmul_rn(o[u][nt][e], corr[u][e >> 1]),",
                 "          for (int e = 0; e < 4 * 0; ++e)\n            o[u][nt][e] "
                 "= __fadd_rn(__fmul_rn(o[u][nt][e], corr[u][e >> 1]),")],
    # every tile's probabilities by the empty tile's path (the products run)
    "no_probs": [("      probs(std::true_type{}, std::true_type{});",
                  "      probs(std::false_type{}, std::false_type{});")],
    # clock64() per phase of thread 0, written over out[row 0 of each q
    # block, :10]: S1 wait, staging + sums + tree, S2 wait, QK^T, scores,
    # pair wait, probabilities, tree rows, pair wait, P.V + carries.
    "prof": [("  int n = 0;   // visited tiles so far\n",
              "  int n = 0;   // visited tiles so far\n"
              "  long long prof[10] = {}, tp = clock64(), tn;\n"
              "#define PROF(k) do { tn = clock64(); prof[k] += tn - tp; "
              "tp = tn; } while (0)\n"),
             ("    __syncthreads();   // tile n has landed; tile n - 1 is "
              "consumed\n", "    PROF(9);\n    __syncthreads();\n    PROF(0);\n"),
             ("    __syncthreads();   // the sums and partials are visible; "
              "the err/sig\n", "    PROF(1);\n    __syncthreads();\n    PROF(2);\n"),
             ("          tile_mma<kKs>(acc, qa[u], smem_addr(Kb) + 64 * h * L.ld, "
              "L.ld, nks,\n                        snt, lane);\n",
              "          tile_mma<kKs>(acc, qa[u], smem_addr(Kb) + 64 * h * L.ld, "
              "L.ld, nks,\n                        snt, lane);\n        PROF(3);\n"),
             ("      pair_sync(w);\n", "      PROF(4);\n      pair_sync(w);\n"
              "      PROF(5);\n"),
             ("    if (pow2) {\n      tree_rows(", "    PROF(6);\n    if (pow2) "
              "{\n      tree_rows("),
             ("      pair_sync(w);   // both halves' p_int rows and sums are in\n",
              "      PROF(7);\n      pair_sync(w);\n      PROF(8);\n"),
             ("      if (h == 0 && tq == 0) {\n        ml[2 * qrow] = m_run[u][r];\n"
              "        ml[2 * qrow + 1] = l_run[u][r];\n      }\n    }\n",
              "      if (h == 0 && tq == 0) {\n        ml[2 * qrow] = m_run[u][r];\n"
              "        ml[2 * qrow + 1] = l_run[u][r];\n      }\n    }\n"
              "  if (t == 0)\n    for (int k_ = 0; k_ < 10; ++k_)\n"
              "      out[(static_cast<long long>(bh) * S.sq + q0) * hd + k_] = "
              "static_cast<float>(prof[k_]);\n")],
}


def variant_source(text: str, name: str) -> str:
    """The kernel's source with the edits of ``name`` (``a+b`` joins);
    ``file:PATH`` is the kernel source at PATH as it is (another
    checkout's, for a comparison inside one call)."""
    if name.startswith("file:"):
        from pathlib import Path
        return Path(name[5:]).read_text()
    for part in name.split("+"):
        if part == "base":
            continue
        for old, new in EDITS[part]:
            if old not in text:
                raise KeyError(f"variant {part}: text not in the source: "
                               f"{old[:60]!r}")
            text = text.replace(old, new)
    return text


def build_variants(names) -> dict:
    """Compile every variant in parallel; ``{name: (library, ptxas log)}``."""
    out_dir = build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "int8_attention.cu").read_text()
    jobs = {}
    for name in names:
        src = variant_source(text, name)
        tag = hashlib.sha1(src.encode()).hexdigest()[:10]
        cu = out_dir / f"attn_{tag}.cu"
        cu.write_text(src)
        lib = out_dir / f"libattn_{tag}.so"
        jobs[name] = (lib, build.start_nvcc(cu, lib, "-I", str(build.CSRC)))
    built = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        built[name] = (lib, log)
    return built


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="base,no_qk,no_pv,no_rowsums,"
                    "no_tree,no_exp,no_div,no_exp+no_div,no_stage")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 1
    names = args.variants.split(",")
    built = build_variants(dict.fromkeys(names))
    for name, (_, log) in built.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                print(f"[{name}] {ln.strip()}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = configs.get("starcoder2-3b")
    b, s, hd, nkv = 4, 1024, cfg.head_dim, cfg.n_kv
    g = cfg.n_heads // nkv
    bq, bkv = tuning.attention_block(s, s, hd)
    sched = attn.make_schedule(sq=s, skv=s, hd=hd, bq=bq, bkv=bkv, groups=g,
                               mode="sliding", window=cfg.sliding_window,
                               sm_scale=hd ** -0.5)
    q = torch.randint(0, 256, (b * nkv * g, s, hd), generator=gen,
                      device=dev, dtype=torch.uint8)
    k = torch.randint(-127, 128, (b * nkv, s, hd), generator=gen, device=dev,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (b * nkv, s, hd), generator=gen, device=dev,
                      dtype=torch.int8)
    scale_p = 1.0 / 255.0
    regs = torch.tensor([128.0, 1e-5, scale_p, 0.0, scale_p * 0.02, 0.0, 1.0,
                         0.0], device=dev)
    kvl = torch.tensor([s], device=dev, dtype=torch.int32)
    vt = mm.weight_kmajor_cuda(v)
    ref = attn.attention_core_reference(q, k, v, regs, kvl, sched=sched) \
        if args.check else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    for name in names:
        fn = attn.bind(ctypes.CDLL(str(built[name][0])))

        def run():
            return attn.launch(fn, q, k, vt, regs, kvl, sched=sched)
        outs = run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.reps
        verdict = ""
        if ref is not None:
            same = (torch.equal(outs[1][..., 0], ref[1][..., 0])
                    and torch.equal(outs[2][..., :4], ref[2][..., :4])
                    and torch.allclose(outs[0], ref[0], rtol=1e-4, atol=1e-4)
                    and torch.allclose(outs[1][..., 1], ref[1][..., 1],
                                       rtol=1e-5, atol=1e-5)
                    and torch.allclose(outs[2][..., 4:], ref[2][..., 4:],
                                       rtol=1e-4, atol=1e-6))
            verdict = " matches the plain version" if same else " WRONG"
        print(f"variant {name}: {ms:.4f} ms{verdict}", flush=True)
        if "prof" in name.split("+"):
            cyc = outs[0].view(-1, sched.nq, bq, hd)[:, :, 0, :10]
            cyc = cyc.double().mean(dim=(0, 1)).tolist()
            tot = sum(cyc)
            print(f"variant {name}: thread 0's cycles per phase, mean over "
                  f"blocks: " + ", ".join(f"{c:.0f} ({c / tot:.1%})"
                                          for c in cyc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
