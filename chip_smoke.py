#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_knn_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, nvcc (under CUDA_HOME or /usr/local/cuda, or on PATH) and the
checkout's sources; it imports neither jax nor tpu_knn. Phases, each
printed as it ends, each fatal on failure:

 1. environment: torch/CUDA versions, the card's name and power limit;
    IEEE f32 matmuls (no TF32) required;
 2. build: compile csrc/groupmin.cu (f32), csrc/groupmin_wgmma_i8.cu
    (int8), csrc/groupmin_wgmma.cu (bf16x3, bf16),
    csrc/groupmin_elementwise.cu (L1, LINF, LP, JS) and
    csrc/sparse_qdense.cu (the sparse scan) for sm_90a, one nvcc each,
    side by side; registers and spills of every kernel and template
    instance, any ptxas warning or remark on the wgmma pipeline, the build
    time;
 3. the f32 group-min kernel against its plain PyTorch version computed in
    float64, on 131072 sift_like rows, Q in {2048, 1000 (ragged)}; then,
    on the same rows, the int8 kernel bit-equal to its plain version and
    the bf16x3 and bf16 kernels within 1e-5 (relative to the magnitude)
    of theirs and within the certificate's eps of the f32 kernel; then the
    same two checks of the bf16x3 and bf16 kernels at the edge shapes
    Q in {1, 7, 256, 1000, 2048}, N in {128, 128*63, 20096},
    D in {24, 128, 136, 384, 960}; and the int8 kernel bit-equal to its
    plain version at the same Q and N with D in {16, 48, 96, 128, 144,
    384, 640, 960, 2048} (every layout of its plan, printed per D), at a
    power-of-two scale and at another, with rows of all -128 and all 127
    and x_term = 1e30 on trailing rows;
 4. the main path: Index("l2", Params(dim=128), method="seq_search",
    device="cuda") over 1,000,000 sift_like rows (the SIFT-1M shape of
    ann-benchmarks' sift-128-euclidean), 2048 queries at k=10, on the
    two-pass route, with the kernel's launch count, build and query times,
    a per-stage breakdown and the kernel's time against the plain version;
 5. a float64 oracle (plain chunked torch product, independent of the
    code under test) for all 2048 queries at k=10 and k=100, for one
    knn_query, and for both routes at small sizes (3000 rows single-pass,
    20000 rows two-pass);
 6. the int8 path: Index("l2sqr_sift", ..., data_type="dense_uint8_vector",
    dist_type="int", device="cuda") over the uint8 rounding of the same
    1M rows (SIFT's native byte format), 2048 queries at k=10, against an
    exact integer oracle, with times, a breakdown, kernel vs plain and
    the kernel in turns with the f32 kernel (f32, int8, int8, f32);
 7. the reduced tiers: the 1M x 128 f32 index built with pass1Precision
    "high" and then "bfloat16", k=10 and k=100, bit-identical to the f32
    tier, with the certified fraction, the redone blocks and times; each
    reduced kernel at those shapes within 1e-5 of its plain version and
    within the certificate's eps of the f32 kernel;
 8. a forced fallback: duplicated rows across groups make the
    certificate fail in the first 256-query block, which re-runs the f32
    kernel, while under "high" the second block keeps its certified
    reduced selection; ids still match the float64 oracle except on ties.
 8b. gist-960's width: Index("l2", Params(dim=960)) over 20,096
    sift_like rows, 256 queries, the f32 tier against the float64 oracle
    and "high"/"bfloat16" (K chunks in the kernel) bit-identical to it.

Added phases (the first two run right after phase 6, on the indexes of
phases 4 and 6, before phase 7 rebuilds phase 4's index):

 9. range: range_query_batch of the 2048 queries on phase 4's 1M l2
    index, at the median over queries of the k=10 result's 10th distance,
    against a chunked float64 oracle (counts and id sets equal except for
    points whose f64 distance lies within the f32 error bound of the
    radius); then on phase 6's l2sqr_sift index at the integer radius of
    its 10th distance, against the exact integer oracle, and range_query
    of one point against its batch row; the largest count, the cap, a
    median of 5, the peak memory and the device ms of the two passes;
10. persist: phase 4's index saved with save_data True and False, loaded
    back with Index.load(path, load_data, device="cuda") in both load
    modes; knn_query_batch and knn_query_batch_async results
    bit-identical to those before the save; save and load seconds and
    artifact sizes;
11. angular (full width): the glove-100-angular shape,
    eval.datasets.clustered(1_185_562, 100, seed=1), the first 1,183,514
    rows the corpus and the last 2048 the queries, through
    Index("angulardist", Params(dim=100), method="seq_search",
    device="cuda") at k=10 and k=100 on the two-pass route, against a
    float64 oracle on the cosine similarity of the normalized rows; the f32
    and bf16x3 kernels at these shapes (scale -1, no row terms) against
    their plain versions; pass1Precision "high" bit-identical to f32;
    cosinesimil and negdotprod at k=10 on the same data;
12. gold standard and metrics: GoldStandard over the angular corpus equal
    to the index's results, its cache round trip exact, and
    eval.metrics of the "high" results against it (recall 1, number
    closer 0);
13. precision: phase 5's 3000-row single-pass index with precision
    "high" (ids equal to the f64 oracle except on ties of the tier's
    error bound) and "bfloat16" (recall@10 against the f32 gold).

14. a NaN distance: 20,000 x 16 rows with +inf in row 7, k=5, two-pass
    route on the card: the f32 kernel's group mins (min.NaN.f32) NaN in
    the same cells as its plain version's (torch.min), and every query
    whose norm identity gives inf - inf gets row 7 first from
    knn_query_batch, as on the CPU; (the kernel edge sweep of phase 3
    also holds the f32, bf16x3 and bf16 kernels to their plain versions
    with an inf row, NaN cell for NaN cell);
15. hnsw, the default method: Index("l2", Params(dim=128), device="cuda")
    with no method= over sift_like(102_048, 128, seed=0) (100,000 corpus
    rows, 2048 queries: bench.py's HNSW cell), build_index(M=16,
    efConstruction=200, waveSize=1024) by insertion waves with the int8
    construction store; build seconds and peak memory; check_graph all
    zero; recall@10 against GoldStandard (which runs the f32 kernel) and
    qps (warm, best of 3) at efSearch 10, 14, 20, 50, 100, 200, recall
    >= 0.95 at 20 and >= 0.99 at 100; every distance within rtol 5e-3 of
    its float64 value; loop iterations, syncs and score mismatches per
    search; identical results with a sync every 8 iterations; range_query
    raises; save and Index.load(device="cuda") give identical answers;
    replicateNeighbors=1 (bf16 and int8) within 0.01 of the plain recall,
    distances exact, the store counted by memory_usage_bytes; at 10,000 x
    128 (cut from 20,000) two builds from one seed give equal graphs and results, a reversed
    batch the reversed results, post=1 keeps check_graph zero; l2sqr_sift
    and angulardist over 20,000 rows (ramped head waves) return a
    self-query first and reach recall@10 >= 0.9 at efSearch=100. (The two
    20,000-row builds with replicateNeighbors=1 through build_index were
    cut: the 100,000-row cell holds both stores, the CPU tests the
    parameters' way in.)
16. nnd, the default index at SIFT-1M: Index("l2", Params(dim=128),
    device="cuda") over phase 4's 1,000,000 rows, build_index with
    bench.py's Params1M (M=16, efConstruction=100, waveSize=1024,
    replicateNeighbors=1, nbrStoreDtype="int8"; buildAlgo auto routes it
    to NN-descent) and nndProfile=1 (a device sync and a log line at each
    phase mark); build seconds, the phase split, the updates of each
    descent sweep, repaired nodes, peak memory, check_graph all zero and
    no node unreached from the entry; recall@10 against phase 4's exact
    ids (held to the float64 oracle) and qps (warm, best of 3) at
    bench.py's efSearch set 10-14, 20, 50, recall >= 0.95 at 20, every
    distance within rtol 5e-3 of its float64 value; then 10,000-row cells (cut from 20,000)
    with buildAlgo="nndescent" below the threshold: the same seed twice
    (torch.equal on every level), l2sqr_sift on uint8 rows, cosinesimil on
    clustered rows, one build with nndRevMode="slots",
    nndStoreDtype="float32" (the wide-row branch at D=128) and
    nndPolishStore=0 together (three one-option cells before), and D=960
    (the wide-row branch of the int8 store), each with check_graph all
    zero and recall@10 at efSearch=50 against GoldStandard.
17. dense, the other dense spaces, over seeded Dirichlet(0.1) histograms
    (1,002,048 x 128 in f32, some components 0) and phase 4's rows:
    kldivgenfast over 1M of them with 2048 queries at k=10 on the
    two-pass route (the f32 kernel on log rows and a negative q_term):
    build, median of 7, the stage breakdown, the kernel against its
    float64 plain version on these inputs and its bound, ids against a
    float64 oracle; pass1Precision high and bfloat16 bit-identical to the
    f32 tier with their certified fractions, each reduced kernel within
    1e-5 of its plain version and within eps of the f32 kernel; l1 over
    phase 4's 1M rows, pass 1 one launch of the elementwise group-min
    kernel (csrc/groupmin_elementwise.cu; median of 7 and its split, 256
    queries against the f64 oracle); that kernel's group-min and distance
    epilogues in each form (L1, LINF, LP at p=3 (a product chain) and
    p=0.7 (ex2 lg2 on the MUFU), JS and its sqrt post) against their plain
    versions on 65,536 of phase 4's rows and of the histograms with 2048
    queries (LINF bit-equal, the others within rtol 5e-3), their times
    beside the plain versions', torch.cdist's and their bounds (least
    FP32 and MUFU operations an element pair; the SASS's count beside),
    and an edge sweep with NaN, +-inf and zero rows, ragged Q and N, D
    8..136, lp at p 0.5, 0.7 and 3-8, JS self pairs exactly 0; its
    batched epilogue (pass 2, the graph scorers, the heuristic's pairs)
    against its plain version over an edge sweep (every form and LP
    instance, Cq 1, 5, 40, ragged K, D 8..136, NaN, +-inf, zero and tiny
    cells, +inf pads), the JS pair of two 2e38 cells finite in all three
    epilogues, and at pass 2's shape (1024 queries x 1536 gathered rows)
    for l1 and JS and a heuristic pair shape (1024 x 100 x 100) for l1,
    with times beside the plain versions', batched torch.cdist's and the
    bound; a guard that counts the plain versions' calls on CUDA tensors
    in every index run of the phase and requires 0; jsdivfast
    and renyidiv_fast (alpha 0.75) over the 1M histograms at 256 queries;
    every dense name at 20,000 rows (two-pass) and 3,000 (single pass),
    256 queries each, lp at p=3 and at p=0.7 and abdiv at alpha 1.2, beta
    0.7, with range on l1 and kldivgenfast, the
    elementwise kernel's launches checked on each, all against float64
    oracles of the reference formulas (ids equal except on ties within
    twice the f32 bound); HNSW, the
    default Index("kldivgenfast", Params(dim=128)) over 20,000
    histograms (cut from 100,000; waves, M=16, efConstruction=200,
    waveSize=1024) with
    check_graph all zero, recall@10 and qps at efSearch 20, 100, 400,
    1000, exact distances, and Index("l1") over 20,000 rows (the batched
    epilogue's pairs) with check_graph zero, self-queries first, recall@10
    at efSearch=100 >= 0.9 and batched launches; l1 at 20,000 rows
    through vptree, napp, sw-graph and an hnsw build asked for
    NN-descent (which needs an affine form and builds by waves, as in
    tpu_knn), each held to the two-pass scan's ids.
18. sparse, the sparse spaces over seeded sparse_like bag-of-words rows:
    (a) bench.py's config 5: cosinesimil_sparse over 100,000 rows (vocab
    30,000, 64 terms a row), 512 queries at k=10; the exact scan (median
    of 5) against a float64 scipy oracle; (b) the default HNSW build on the
    same rows (the JL-sketch proxy, sketchDim=1024, exactBase, exactPairs;
    M=16, efConstruction=100, waveSize=512): build seconds, peak memory,
    check_graph all zero, recall@10 against the scan and qps (best of 3) at
    efSearch 50 and 100 (recall >= 0.95 at 100), every distance its id's
    f64 distance, and save/load in each mode with results bit-identical;
    (c) the 1M exact scan (1,000,000 rows, vocab 60,000): median of 5, peak
    memory, the kernel's launches (every count set to 0 just before it) and
    the wall's split between the kernel and the top-k merges, 64 queries
    against the f64 oracle; before it, [sparse] kernel: csrc/sparse_qdense.cu
    in every form (negdot, querynorm, cosine, angular, the 0/1 forms,
    jaccard) against its plain version at (a)'s and (c)'s chunk shapes
    (512 x 4080 x 64, vocab 30,080 and 60,032; the 0/1 forms and jaccard
    equal, the others within rtol 5e-3), its time beside the plain
    version's, torch.sparse.mm's of the dots alone and its bound (beside
    the dense-table gather's), over (c)'s whole corpus too, at a dense-table
    shape (vocab 1,024, nnz 64, 100,000 rows), and an edge sweep (Q
    1-4096, C 1-1000, rows of 1-200 slots, empty, zero-norm, +-inf and NaN
    rows, out-of-vocabulary query ids, id 1 in every query, corpus arrays
    off a 16-byte boundary); (d) at 5,000 rows every
    sparse name's kNN and range against its f64 oracle, HNSW by exact waves
    (sketchDim=0, moved here from 100,000 rows, its wave phases timed),
    with sketchQuery=1 and with exactPost=1 and exactShrink=1, l2_sparse
    and sparse_jaccard HNSW (recall@10 at efSearch=100 >= 0.9, 0.5, 0.9,
    0.85, 0.9), R drawn on the card against R drawn on the CPU, whether the
    native pack_csr built. The scans of the dot spaces and Jaccard run
    csrc/sparse_qdense.cu (one launch a chunk); the Lp family's lookup and
    the graph's gathered and pair scorers are torch ops, as they are XLA
    ops in tpu_knn. A guard counts the sparse scan's plain versions called
    on CUDA tensors over phases 18-20 and requires 0.
19. bits, word_embed, NAPP and the inverted index: (a) [bits] SimHash
    codes of phase 4's rows (signs of a seeded [128, 256] Gaussian
    projection, 256 bits packed to uint32 words) through
    add_bit_batch_packed, 1,000,000 codes, 2048 queries, k=10: bit_hamming
    on the two-pass route (the f32 group-min kernel on the 0/1 rows,
    launched, bit-equal to its plain version, timed against it and its
    bound at D=256) with the median of 5 and its stage split, distances
    equal to an exact integer popcount oracle and every returned id's
    popcount(q XOR x) its distance; bit_jaccard (block route, median of 3)
    against a float64 oracle; (b) [embed] word_embed over 20,000
    glove_like(20_256, 100, seed=0) rows written as "w<i> v1 ... v100"
    lines, 256 queries as bare words of the preloaded file, dist l2 and
    cosine on seq_search and HNSW (M=16, efConstruction=100), results equal
    to Index("l2")/Index("cosinesimil") over the parsed vectors and after
    save/load of the string store; (c) [napp] NAPP on phase 18 (a)'s
    100,000 rows and 512 queries (numPivot=512, numPrefix=32, minTimes 2-4,
    invProcAlg scan and gather): build seconds and peak, recall@10 against
    the exact scan (>= 0.95 at minTimes=2 on the scan route), qps and
    dist_comps; (d) NAPP over phase 4's 1M rows (l2, minTimes=2) against
    phase 4's exact ids (recall >= 0.95), and a 20,000-row range with every
    row a candidate equal to seq_search's; (e) [invindx] simple_invindx
    over phase 18 (c)'s 1M rows under negdotprod_sparse_fast at 1, 32 and
    512 queries: ms a batch, touched documents, peak memory, ids equal to
    the exact scan's except on ties, two calls equal and a reversed batch
    the same bits. Each new space and method is saved (save_data True and
    False) and loaded on the card with bit-identical results: 20,000-code
    indexes of both bit spaces, (c)'s NAPP index on the gather route,
    (d)'s 20,000-row NAPP index and a 100,000-row simple_invindx. Only
    (a)'s bit_hamming runs a kernel; the rest is torch ops, as it is XLA
    ops in tpu_knn. (e) runs after phase 20, once the 1M dense rows are
    freed.
20. VP-tree, sw-graph, the string spaces, SQFD, fusion and dummy (torch
    ops, as they are XLA ops in tpu_knn; dummy reaches the f32 kernel
    through seq_search): (a) [vptree] VP-tree over phase 4's 1,000,000
    rows (l2, bucketSize=64, seed 0): build seconds and peak, alpha=2 at
    maxLeavesToVisit 16 / 32 / 64 on the gathered route against phase 4's
    exact ids (recall >= 0.95 at 64, not falling as the cap grows, every
    distance its f64 distance) with qps (median of 3), the exact pruner on
    the masked route (256 queries, ids phase 4's up to ties), range at
    phase 9's radius equal id set for id set to seq_search's; (d) [sqfd]
    the three SQFD names over 10,000 seeded signatures of 8-16 clusters in
    d=8 and sparse_dense_fusion over 10,000 objects of a 128-d dense and a
    sparse_like component, 64 queries each, against float64 numpy oracles
    (ids a top-10 up to ties, distances within rtol 5e-3), range on one of
    each; dummy with doSeqSearch=1 bit-equal to seq_search over 20,000 of
    phase 4's rows with groupmin_f32 launched, and empty without it;
    (b) [swgraph] sw-graph (NN=16, efConstruction=100, waveSize=1024) over
    the first 97,952 of HNSW-100k's corpus rows, the last 2,048 added
    after the build (built kept, each added row its own first hit), 1,000
    seeded deletions with neighbors_only and 1,000 with none, check_graph
    zero, no deleted id returned, recall@10 against seq_search over the
    survivors at efSearch 20 / 50 / 100 (>= 0.9 at 100) with qps, save/load
    with the mask bit-identical; (c) [string] leven and normleven over
    100,000 seeded DNA-like strings (ACGT, lengths 24-40), 256 queries of
    1-4 seeded edits: seq_search ms a batch, the first 16 queries'
    distances equal to the native Levenshtein over every pair, the chunk
    used; HNSW leven over 5,000 of them (M=16, efConstruction=100; cut
    from 20,000, then 10,000), tie-aware recall@10 at efSearch=100 >= 0.9 against the
    scan.
21. the CLI and the mesh layer (after 20 (a)-(d), before 19 (e)): (a)
    [cli] phase 4's 1,000,000 rows written as .fvecs, then
    tpu_knn_torch.cli.main in-process with --method seq_search --knn 10
    --maxNumQuery 2048 --testSetQty 1 --device cuda: recall 1,
    groupmin_f32 launched, the seconds end to end; hnsw (M=16,
    efConstruction=200, efSearch 20 and 100) over 10,000 of the rows with
    --queryFile and --saveIndex, then --loadIndex: equal tables; one
    subprocess ``python -m tpu_knn_torch`` (seq_search, recall 1); (b)
    [mesh] Index("l2", Params(dim=128), method="seq_search", mesh=4,
    device="cuda") over phase 4's rows: 4 logical shards on the one card,
    each scanned on the two-pass route (one groupmin_f32 launch a shard a
    batch), ids equal to phase 4's except on f32 ties, every distance
    within rtol 5e-3 of its float64 value, ms a batch (median of 5) in
    turns with the single-device index, peak memory; range_query_batch at
    phase 9's radius with the single-device range's id sets; the two-tier
    merge on make_mesh2(2, 2) equal to the flat merge; (c) [mesh] the
    default Index("l2", Params(dim=128), mesh=4) over the first 20,000 of
    HNSW-100k's rows with its 2048 queries (cut from all 100,000 when the
    whole script passed ~1,050 s, then from 40,000; M=16, efConstruction=200,
    waveSize=1024, stacked waves): build
    seconds and peak, check_graph zero on every shard, recall@10 against
    seq_search and qps (best of 3) at efSearch 20 and 100 (>= 0.95 and
    0.99), save/load bit-identical with mesh_devices 4 in the header; then
    buildAlgo="nndescent" over 4 x 5,000 rows twice from one seed:
    check_graph zero, the graphs equal (torch.equal), recall@10 at
    efSearch=50. The mesh layer and the CLI are torch ops and host code,
    as they are XLA ops and host code in tpu_knn; the exact scan reaches
    the f32 kernel. (d) [mesh] one groupmin_f32 launch on a shard's rows
    timed by CUDA events, with its share of the per-launch bound.
22. [async] knn_query_batch_async, on no index of its own: on phase 4's
    1M l2 index right after phase 4 (a) the 2048-query dispatch returns
    while its batch's CUDA event has not completed (dispatch ms beside
    phase 4's synchronous wall), the result bit-identical to phase 4's;
    (b) 8 distinct batches of 2048 sift_like queries (seed 22) in flight
    at once, each bit-identical to knn_query_batch of the same batch, with
    8 groupmin_f32 launches counted over the in-flight run; (c) the 8
    in flight against 8 serial calls, in turns (in flight, serial,
    serial, in flight), three rounds: ms and qps of both; inside phase 15
    on HNSW-100k at efSearch=20 (d) (b) and (c) again, and (e) a batch
    dispatched at efSearch=20 gives the synchronous efSearch=20 result
    though the method is set to efSearch=100 before it is read (and
    again through Index.set_query_time_params, which drains first).

Every [kernel] line at the main path's shapes prints the kernel's bound
(the larger of its bytes over 3.35 TB/s and its operations over the
tier's dense peak: 67 TFLOP/s f32, 989 bf16, 1,979 TOP/s int8) and its
share of it. No kernel lies on HNSW's own path, waves or NN-descent (their
loops are torch ops, as they are XLA ops in tpu_knn); it reaches the f32
kernel through GoldStandard and phase 4's exact ids. The exact scan of
the elementwise spaces (l1, linf, lp, dummy, JS) runs
csrc/groupmin_elementwise.cu, that of the sparse dot spaces and Jaccard
csrc/sparse_qdense.cu; Renyi's block scan is torch ops, as it is XLA ops
in tpu_knn. The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Exits non-zero without a result when there
is no CUDA card or any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

N_CORPUS = 1_000_000
N_QUERIES = 2048
DIM = 128
K = 10
N_KERNEL_CHECK = 131_072
U = 2.0 ** -24  # f32 unit roundoff


def _require(ok: bool, message) -> None:
    """Fail the run (unlike assert, not removed under python -O)."""
    if not ok:
        raise RuntimeError(message())


def _phase(name: str, t0: float) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    print(f"[phase] {name} done in {t - t0:.3f} s", flush=True)
    return t


def _cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _ptxas_summary(log: str) -> list[str]:
    """'kernel: registers ..., spills ...' for each entry function of nvcc's
    -Xptxas=-v output (empty when the library came from the build cache);
    template arguments in angle brackets."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"entry function '.*?(groupmin_[a-z0-9]+_kernel|elementwise_(?:batched|pair)_kernel|split_queries_kernel"
                      r"|image_queries_kernel)(I\w*)?", ln)
        if m:
            args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
            name, spill = m.group(1) + (f"<{','.join(args)}>" if args else ""), ""
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
    return out


def _ptxas_remarks(log: str) -> dict:
    """{"C75xx <template arguments>": count} of ptxas's remarks on the wgmma
    pipeline in nvcc's -Xptxas=-v output."""
    out: dict = {}
    for m in re.finditer(r"\((C75\d+)\).*?_kernel(I\w*?)EvNS", log):
        key = f"{m.group(1)} <{','.join(re.findall(r'L[ib](\d+)E', m.group(2) + 'E'))}>"
        out[key] = out.get(key, 0) + 1
    return out


#: dense peaks of one H100 SXM (NVIDIA's data sheet) per tier, and its HBM rate
PEAK_OPS = {"float32": 67e12, "int8": 1979e12, "high": 989e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def _bound_ms(tier: str, q, x):
    """(least ms, "bytes" or "operations") of one group-min call: q, x and
    the two row terms read once and the [Q, N/128] mins written once, over
    the HBM rate, against its multiply-adds (x2; three bf16 products per
    pair for bf16x3) over the tier's dense peak."""
    qn, d = q.shape
    n = x.shape[0]
    nbytes = q.numel() * q.element_size() + x.numel() * x.element_size() + 4 * (qn + n) + 4 * qn * (n // 128)
    ops = 2.0 * qn * n * d * (3 if tier == "high" else 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[tier]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def _edge_sweep(dev, kernel_err):
    """The bf16x3 and bf16 kernels at the edge shapes of the wgmma design:
    Q in {1, 7, 256, 1000, 2048} (one partial 64-query tile up to 32 full
    ones), N in {128, 128*63, 20096} (one group; an odd group count, so a
    two-group corpus tile is half empty), D in {24, 128, 136, 384, 960}
    (k-step tails; one, two, three, six and fifteen 64-k slabs, which take
    each buffering mode of the kernel: at 384 one consumer warpgroup for
    bf16x3, at 960, gist's width, K chunks for both tiers). Each within
    1e-5 of the magnitude of its plain version and within the
    certificate's eps of the f32 kernel."""
    import torch
    from tpu_knn_torch.core.dataset import DenseDeviceData
    from tpu_knn_torch.eval.datasets import sift_like
    from tpu_knn_torch.methods import seq_search as SS
    from tpu_knn_torch.ops import groupmin as GM
    from tpu_knn_torch.spaces.dense import ensure_cert_metadata

    nmax, qmax = 20096, 2048
    data = sift_like(nmax + qmax, 960, seed=2)
    worst = {tier: [0.0, 0.0] for tier in ("high", "bfloat16")}
    shapes = 0
    for d in (24, 128, 136, 384, 960):
        x_all = torch.from_numpy(np.ascontiguousarray(data[:nmax, :d])).to(dev)
        q_all = torch.from_numpy(np.ascontiguousarray(data[nmax:, :d])).to(dev)
        for n in (128, 128 * 63, nmax):
            x = x_all[:n]
            xt = (x * x).sum(1)
            slab = DenseDeviceData(vecs=x, ids=torch.arange(n, dtype=torch.int32, device=dev), count=n, dim=d)
            ensure_cert_metadata(slab)
            for nq in (1, 7, 256, 1000, qmax):
                q = q_all[:nq]
                qt = (q * q).sum(1)
                f32 = GM.fused_groupmin(q, x, qt, xt, -2.0)
                _, mag = _groupmin_bound(q, x, qt, xt, -2.0)
                for tier in ("high", "bfloat16"):
                    out = GM.fused_groupmin(q, x, qt, xt, -2.0, precision=tier)
                    torch.cuda.synchronize()
                    ref = GM.fused_groupmin_reference(q, x, qt, xt, -2.0, precision=tier)
                    diff = (out.double() - ref.double()).abs()
                    rel = float((diff / mag).max())
                    eps = SS._pass1_eps(q, slab, -2.0, tier).double()
                    ratio = float(((out.double() - f32.double()).abs().amax(dim=1) / eps).max())
                    _require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                             lambda: f"{tier} at Q={nq} N={n} D={d}: output not finite or not {tuple(ref.shape)}")
                    _require(rel <= 1e-5, lambda: f"{tier} kernel vs plain at Q={nq} N={n} D={d}: {rel} of the magnitude")
                    _require(ratio <= 1.0, lambda: f"{tier} kernel beyond eps of the f32 kernel at Q={nq} N={n} D={d}: {ratio}")
                    kernel_err[tier] = max(kernel_err[tier], float(diff.max()))
                    worst[tier] = [max(worst[tier][0], rel), max(worst[tier][1], ratio)]
                shapes += 1
    for tier, (rel, ratio) in worst.items():
        print(f"[kernel] {tier} edge sweep, {shapes} shapes (Q in 1, 7, 256, 1000, 2048; N in 128, 8064, "
              f"20096; D in 24, 128, 136, 384, 960): max |kernel - plain| relative to the magnitude {rel:.3g} (limit "
              f"1e-5); max over queries of max_g |kernel - f32 kernel| / eps {ratio:.3g} (limit 1)", flush=True)
    # a corpus row that holds +inf: under bf16x3 its split gives lo = inf - inf,
    # so every query's min over that row's group is NaN; under bf16 and f32 the
    # queries whose product is +inf give inf - inf there and the others +inf.
    # Each kernel carries those NaNs as its plain version does
    inf_shapes, inf_worst = 0, {tier: 0.0 for tier in ("float32", "high", "bfloat16")}
    for d in (24, 128, 960):
        for n in (128, nmax):
            x = torch.from_numpy(np.ascontiguousarray(data[:n, :d])).to(dev)
            for nq in (7, qmax):
                q = torch.from_numpy(np.ascontiguousarray(data[nmax:nmax + nq, :d])).to(dev)
                qt = (q * q).sum(1)
                _, mag = _groupmin_bound(q, x, qt, (x * x).sum(1), -2.0)
                xi = x.clone()
                xi[7, 3] = float("inf")
                xt = (xi * xi).sum(1)
                for tier in inf_worst:
                    out = GM.fused_groupmin(q, xi, qt, xt, -2.0, precision=tier)
                    torch.cuda.synchronize()
                    ref = GM.fused_groupmin_reference(q, xi, qt, xt, -2.0, precision=tier)
                    nan_k, nan_p = torch.isnan(out), torch.isnan(ref)
                    fin = torch.isfinite(ref)
                    err = (out.double() - ref.double()).abs()[fin]
                    rel = float((err / mag.expand_as(out)[fin]).max()) if err.numel() else 0.0
                    _require(torch.equal(nan_k, nan_p) and bool(nan_p[:, 0].any())
                             and torch.equal(out[~fin & ~nan_p], ref[~fin & ~nan_p]) and rel <= 1e-5,
                             lambda: f"{tier} with an inf row at Q={nq} N={n} D={d}: NaN in {int(nan_k.sum())} "
                                     f"cells of the kernel, {int(nan_p.sum())} of plain, {int((nan_k != nan_p).sum())} "
                                     f"differ; finite cells {rel} of the magnitude")
                    inf_worst[tier] = max(inf_worst[tier], rel)
                    if tier != "float32" and err.numel():
                        kernel_err[tier] = max(kernel_err[tier], float(err.max()))
                inf_shapes += 1
    print(f"[kernel] an inf row (row 7, column 3), {inf_shapes} shapes (Q in 7, 2048; N in 128, 20096; D in 24, "
          f"128, 960): f32, bf16x3 and bf16 kernels NaN in the same cells as their plain versions, +inf where they "
          f"are +inf; finite cells within {json.dumps({t: float(f'{v:.3g}') for t, v in inf_worst.items()})} "
          f"of the magnitude (limit 1e-5)", flush=True)


def _edge_sweep_i8(dev, kernel_err):
    """The int8 kernel at the edge shapes of its design, bit-equal
    (torch.equal) to its plain version: Q in {1, 7, 256, 1000, 2048} (one
    partial 64-query tile up to 32 full ones), N in {128, 128*63, 20096}
    (one group; group counts that leave a four-group corpus tile partly
    empty), D in {16, 48, 96, 128, 144, 384, 640, 960, 2048} (one to four
    k-steps in the last slab; one to sixteen 128-k slabs, which take every
    layout of the kernel's plan, printed per D: two consumer warpgroups of
    two groups each with two corpus buffers and with one, of one group
    each, one warpgroup, and K chunks at 2048). Uniform random int8 values, with rows of all -128 and
    all 127 in the queries and in the first and last groups (the largest
    |dot|, D * 2^14; at D = 2048 all values are halved, so that the plain
    version's f32 sums stay exact), non-integer row terms, and x_term = 1e30
    on the 37 trailing rows. Each shape at scale -2 (a power of two: the
    fused multiply-add epilogue) and -0.3 (multiply, then add)."""
    import torch
    from tpu_knn_torch.ops import groupmin as GM

    nmax, qmax = 20096, 2048
    dims = (16, 48, 96, 128, 144, 384, 640, 960, 2048)
    rng = np.random.default_rng(5)
    x_np = rng.integers(-128, 128, size=(nmax, max(dims)), dtype=np.int8)
    q_np = rng.integers(-128, 128, size=(qmax, max(dims)), dtype=np.int8)
    for row, v in ((0, -128), (1, 127), (128 * 63 - 50, -128), (nmax - 50, 127)):
        x_np[row] = v
    for row, v in ((0, -128), (6, 127), (999, -128), (qmax - 1, 127)):
        q_np[row] = v
    xt_all = torch.from_numpy((rng.random(nmax) * 2e6).astype(np.float32)).to(dev)
    qt_all = torch.from_numpy((rng.random(qmax) * 2e6).astype(np.float32)).to(dev)
    shapes = runs = 0
    layouts = set()
    for d in dims:
        plans = {scale: GM.int8_plan(d, scale) for scale in (-2.0, -0.3)}
        p = plans[-2.0]
        layouts.add((p["warpgroups"], p["groups_each"], p["two_buffers"], p["slabs_resident"] < -(-d // 128)))
        print(f"[kernel] int8 plan at D={d} ({-(-d // 128)} slabs): {json.dumps(p)}; at scale -0.3 "
              f"pow2_scale {plans[-0.3]['pow2_scale']}", flush=True)
        _require(p["pow2_scale"] == 1 and plans[-0.3]["pow2_scale"] == 0,
                 lambda: f"int8 plan at D={d}: the scales did not pick the two epilogues: {plans}")
        # the plain version's f32 matmul is exact only while every partial sum
        # stays within 2^24: past D = 1024 the values are halved (-64 .. 63)
        shift = 1 if d > 1024 else 0
        x_all = torch.from_numpy(np.ascontiguousarray(x_np[:, :d] >> shift)).to(dev)
        q_all = torch.from_numpy(np.ascontiguousarray(q_np[:, :d] >> shift)).to(dev)
        for n in (128, 128 * 63, nmax):
            x = x_all[:n]
            xt = xt_all[:n].clone()
            xt[n - 37:] = 1e30
            for nq in (1, 7, 256, 1000, qmax):
                q, qt = q_all[:nq], qt_all[:nq].contiguous()
                for scale in (-2.0, -0.3):
                    out = GM.fused_groupmin(q, x, qt, xt, scale)
                    torch.cuda.synchronize()
                    ref = GM.fused_groupmin_reference(q, x, qt, xt, scale)
                    _require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                             lambda: f"int8 at Q={nq} N={n} D={d}: output not finite or not {tuple(ref.shape)}")
                    if not torch.equal(out, ref):
                        bad = (out != ref).nonzero()
                        i, g = (int(v) for v in bad[0])
                        raise RuntimeError(
                            f"int8 kernel differs from its plain version at Q={nq} N={n} D={d} scale {scale}: "
                            f"{bad.shape[0]} of {out.numel()} entries, first at query {i} group {g}: "
                            f"{float(out[i, g])!r} against {float(ref[i, g])!r}")
                    kernel_err["int8"] = max(kernel_err["int8"], float((out - ref).abs().max()))
                    runs += 1
                shapes += 1
    _require(len(layouts) == 5, lambda: f"the int8 sweep took {len(layouts)} layouts of the plan, not 5: {layouts}")
    print(f"[kernel] int8 edge sweep, {shapes} shapes x 2 scales = {runs} runs (Q in 1, 7, 256, 1000, 2048; "
          f"N in 128, 8064, 20096; D in {', '.join(map(str, dims))}), {len(layouts)} layouts: every one "
          f"bit-equal to its plain version", flush=True)


def _median_ms(fn, reps: int = 7):
    """(median, min, max) host ms of ``fn``, which returns host numpy (so it is synchronized)."""
    times = []
    for _ in range(reps):
        ts = time.perf_counter()
        fn()
        times.append((time.perf_counter() - ts) * 1e3)
    return statistics.median(times), min(times), max(times)


def _breakdown(idx, queries, k: int, tier: str = "float32", reps: int = 5):
    """Device ms per stage of idx.knn_query_batch(queries, k) on the
    two-pass route (CUDA events, mean of ``reps``), and the query encoding.
    Reduced tiers time pass 1 with its certificate and f32 redo as one
    stage; a space with no affine form times its block-scan pass 1."""
    from tpu_knn_torch.methods import seq_search as SS

    space, m = idx.space, idx.method
    data = m.data
    qpts, _ = idx._bucket_query_points(queries)
    qenc = space.encode_queries(qpts)
    stages = {"encode_queries": _cuda_ms(lambda: space.encode_queries(qpts), reps)}
    if space.pass1_affine() is None:
        def pass1():
            return SS._pass1_block(space, qenc, data, m._chunk, m.precision)

        mins = pass1()
        gsel = SS._select_groups(mins, k)
        # an elementwise form runs one launch of csrc/groupmin_elementwise.cu
        stages["pass1_elementwise" if space.pass1_elementwise() else "pass1_block_scan"] = _cuda_ms(pass1, reps)
        stages["select_groups"] = _cuda_ms(lambda: SS._select_groups(mins, k), reps)
    elif tier == "float32":
        mins = SS._pass1(space, qenc, data)
        gsel = SS._select_groups(mins, k)
        stages["pass1_groupmin"] = _cuda_ms(lambda: SS._pass1(space, qenc, data), reps)
        stages["select_groups"] = _cuda_ms(lambda: SS._select_groups(mins, k), reps)
    else:
        gsel, _, _ = SS._pass1_certified(space, qenc, data, k, tier)
        stages["pass1_certified_select"] = _cuda_ms(
            lambda: SS._pass1_certified(space, qenc, data, k, tier), reps)
    stages["pass2_gather_rescore"] = _cuda_ms(lambda: SS._pass2(space, qenc, data, gsel, k), reps)
    return stages, qenc


def _groupmin_bound(q, x, qt, xt, scale):
    """Per-(query, group) bound on |f32 kernel - exact| for the group mins
    of scale*<q,x> + x_term + q_term: the f32 dot of depth D is within
    D*u*|q||x| (Higham eq. 3.5 with Cauchy-Schwarz), and the scale, the two
    term additions and their operands' rounding add at most 3*u times the
    magnitude M = |scale||q||x| + |x_term| + |q_term|. Row quantities are
    taken as their max over the group."""
    import torch

    d = q.shape[1]
    qn = q.double().norm(dim=1)[:, None]
    xn = x.double().norm(dim=1).view(-1, 128).amax(1)[None, :]
    xtm = xt.double().abs().view(-1, 128).amax(1)[None, :]
    mag = abs(scale) * qn * xn + xtm + qt.double().abs()[:, None]
    return U * (d * abs(scale) * qn * xn + 3.0 * mag), mag


def _oracle_topk(q, x, k: int, chunk: int = 65536):
    """Exact float64 L2 top-k by a plain chunked product (ascending)."""
    best_d, best_i = _oracle_sq_topk(q, x, k, chunk)
    return best_d.clamp_min(0).sqrt(), best_i


def _oracle_sq_topk(q, x, k: int, chunk: int = 65536):
    """Float64 squared-L2 top-k by a plain chunked product (ascending); exact
    for integer-valued inputs such as uint8 descriptors (every sum < 2^53)."""
    import torch

    q64 = q.double()
    qn = (q64 * q64).sum(1, keepdim=True)
    best_d = torch.full((q.shape[0], 0), float("inf"), dtype=torch.float64, device=q.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=q.device)
    for s in range(0, x.shape[0], chunk):
        xc = x[s:s + chunk].double()
        d2 = qn + (xc * xc).sum(1)[None, :] - 2.0 * (q64 @ xc.T)
        dc, ic = torch.topk(d2, min(k, xc.shape[0]), dim=1, largest=False)
        best_d = torch.cat([best_d, dc], 1)
        best_i = torch.cat([best_i, ic + s], 1)
        best_d, sel = torch.topk(best_d, min(k, best_d.shape[1]), dim=1, largest=False)
        best_i = torch.gather(best_i, 1, sel)
    return best_d, best_i


def _same_results(label, d, i, d_ref, i_ref):
    """Distances bit-identical to the reference tier's; ids equal up to the
    order of exactly equal distances (each row holds the same (dist, id) pairs)."""
    _require(np.array_equal(d, d_ref), lambda: (
        f"{label}: distances differ from the f32 tier at {int((d != d_ref).sum())} slots"))
    pairs = np.sort(np.rec.fromarrays([d, i]), axis=1)
    pairs_ref = np.sort(np.rec.fromarrays([d_ref, i_ref]), axis=1)
    _require(np.array_equal(pairs, pairs_ref), lambda: f"{label}: ids differ from the f32 tier")
    print(f"[same] {label}: distances bit-identical to the f32 tier; ids equal at "
          f"{int((i == i_ref).sum())}/{i.size} slots, the rest among exactly equal distances", flush=True)


def _check_against_oracle(label, ids, dists, q, x, k, dot_rel: float = 0.0):
    """Ids must equal the oracle's except on ties. The returned f32
    distances must be within the f32 norm-identity bound
    B = (D+3)*u*(|q|+|x|)^2 of the exact squared distance, so an f32 scan
    cannot order two ids whose exact squared distances differ by less than
    2B: a tie is an exact distance within 1e-5 relative of the oracle's at
    that rank, or a squared distance within 2B of it. ``dot_rel`` widens B
    by 2*dot_rel*|q||x| for a product computed at a reduced tier whose
    error is at most dot_rel*|q||x|."""
    import torch

    dev = q.device
    od, oi = _oracle_topk(q, x, k)
    ids_t = torch.as_tensor(ids, device=dev)
    _require(ids_t.shape == oi.shape and bool((ids_t >= 0).all()), lambda: f"{label}: missing results")
    diff = ids_t != oi
    q64 = q.double()
    xr = x[ids_t].double()  # [Q, k, D] rows of the returned ids
    exact = ((xr - q64[:, None, :]) ** 2).sum(-1)  # f64 squared distances
    qn, xn = q64.norm(dim=1)[:, None], xr.norm(dim=-1)
    bound = (q.shape[1] + 3) * U * (qn + xn) ** 2 + 2.0 * dot_rel * qn * xn
    rel = (exact.sqrt() - od).abs() / od
    f32_tie = (exact - od * od).abs() <= 2.0 * bound
    bad = diff & (rel > 1e-5) & ~f32_tie
    n_rel = int((diff & (rel <= 1e-5)).sum())
    worst = float(((exact - od * od).abs() / (2.0 * bound))[diff].max()) if bool(diff.any()) else 0.0
    _require(not bool(bad.any()), lambda: (
        f"{label}: {int(bad.sum())} ids differ from the f64 oracle beyond ties; first query "
        f"{int(bad.any(1).nonzero()[0])}, worst relative gap {float(rel[bad].max()):.3g}"
    ))
    d_t = torch.as_tensor(dists, device=dev).double()
    d2_err = (d_t * d_t - exact).abs()
    _require(bool((d2_err <= bound).all()), lambda: (
        f"{label}: distance beyond the f32 bound, worst ratio {float((d2_err / bound).max()):.3g}"
    ))
    print(
        f"[oracle] {label}: {q.shape[0]} queries x k={k}: ids equal to the f64 oracle at "
        f"{int((~diff).sum())}/{diff.numel()} slots; of the other {int(diff.sum())}, {n_rel} tie "
        f"within 1e-5 relative and the rest within the f32 bound (worst gap/2B {worst:.3g}); "
        f"max d^2 error/bound {float((d2_err / bound).max()):.3g}",
        flush=True,
    )


def _dot_topk(q, x, k: int, chunk: int = 65536):
    """Float64 top-k of the largest <q, x> by a plain chunked product:
    (dots [Q, k] descending, positions)."""
    import torch

    q64 = q.double()
    best_v = torch.empty((q.shape[0], 0), dtype=torch.float64, device=q.device)
    best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=q.device)
    for s in range(0, x.shape[0], chunk):
        g = q64 @ x[s:s + chunk].double().T
        v, i = torch.topk(g, min(k, g.shape[1]), dim=1)
        best_v, sel = torch.topk(torch.cat([best_v, v], 1), min(k, best_v.shape[1] + v.shape[1]), dim=1)
        best_i = torch.gather(torch.cat([best_i, i + s], 1), 1, sel)
    return best_v, best_i


def _check_dot_oracle(label, ids, q, x, k: int, dists=None, dot_of=None):
    """Ids of a dot-product space (rows as the index stores them: normalized
    for cosinesimil/angulardist, raw for negdotprod) against a float64
    oracle of <q, x>. An f32 product of depth D is within
    B = (D+2)*u*|q||x| of the exact one, so ids may differ from the
    oracle's only where the two f64 dots lie within 2B. With ``dot_of``
    (returned f64 distances -> the dot they stand for), each must lie
    within B + 16u (the post-transform's rounding) of its id's f64 dot."""
    import torch

    dev = q.device
    ov, oi = _dot_topk(q, x, k)
    ids_t = torch.as_tensor(ids, device=dev).long()
    _require(ids_t.shape == oi.shape and bool((ids_t >= 0).all()), lambda: f"{label}: missing results")
    q64 = q.double()
    xr = x[ids_t].double()
    dot = (xr * q64[:, None, :]).sum(-1)  # f64 <q, x> of the returned ids
    bound = (q.shape[1] + 2) * U * q64.norm(dim=1)[:, None] * xr.norm(dim=-1)
    diff = ids_t != oi
    bad = diff & ((dot - ov).abs() > 2.0 * bound)
    worst = float(((dot - ov).abs() / (2.0 * bound))[diff].max()) if bool(diff.any()) else 0.0
    _require(not bool(bad.any()), lambda: (
        f"{label}: {int(bad.sum())} ids differ from the f64 oracle beyond ties; first query "
        f"{int(bad.any(1).nonzero()[0])}"))
    msg = ""
    if dot_of is not None:
        err = (torch.as_tensor(dot_of(np.asarray(dists, np.float64)), device=dev) - dot).abs()
        ratio = float((err / (bound + 16 * U)).max())
        _require(ratio <= 1.0, lambda: f"{label}: distance beyond the f32 bound, worst ratio {ratio:.3g}")
        msg = f"; max distance error/bound {ratio:.3g}"
    print(f"[oracle] {label}: {q.shape[0]} queries x k={k}: ids equal to the f64 oracle at "
          f"{int((~diff).sum())}/{diff.numel()} slots, the other {int(diff.sum())} within the f32 "
          f"bound of the oracle's dot (worst gap/2B {worst:.3g}){msg}", flush=True)


def _range_check_l2(label, res, q, x, radius: float, chunk: int = 32768):
    """Range results of the l2 space against a float64 oracle. The f32
    distance of a pair is within the norm-identity bound
    B = (D+3)*u*(|q|+|x|)^2 of the exact squared distance, and its sqrt
    and the comparison add at most 4*u*r^2; so a point is certainly in
    when d64^2 < r^2 - band, certainly out when d64^2 > r^2 + band, and
    undecided in between. Every returned id must not be certainly out, and
    each query must return every certainly-in point (returned ids are
    distinct, so the number of returned certainly-in ids must equal the
    oracle's count of them). Returns (certainly-in counts, undecided
    counts) per query."""
    import torch

    dev = q.device
    q64 = q.double()
    qn2 = (q64 * q64).sum(1, keepdim=True)
    qn = qn2.sqrt()
    r2 = float(radius) ** 2
    sure_in = torch.zeros(q.shape[0], dtype=torch.int64, device=dev)
    undecided = torch.zeros_like(sure_in)
    for s in range(0, x.shape[0], chunk):
        xc = x[s:s + chunk].double()
        xn2 = (xc * xc).sum(1)[None, :]
        d2 = qn2 + xn2 - 2.0 * (q64 @ xc.T)
        band = (q.shape[1] + 3) * U * (qn + xn2.sqrt()) ** 2 + 4 * U * r2
        sure_in += (d2 < r2 - band).sum(1)
        undecided += ((d2 - r2).abs() <= band).sum(1)
    qi = torch.as_tensor(np.repeat(np.arange(len(res)), [len(r.ids) for r in res]), device=dev)
    ids = torch.as_tensor(np.concatenate([r.ids for r in res]).astype(np.int64), device=dev)
    dists = torch.as_tensor(np.concatenate([r.dists for r in res]), device=dev).double()
    xr = x[ids].double()
    d2 = ((xr - q64[qi]) ** 2).sum(1)
    band = (q.shape[1] + 3) * U * (qn[qi, 0] + xr.norm(dim=1)) ** 2 + 4 * U * r2
    _require(not bool((d2 > r2 + band).any()), lambda: f"{label}: a returned point lies outside the radius")
    got_in = torch.zeros_like(sure_in).index_add_(0, qi, (d2 < r2 - band).long())
    _require(torch.equal(got_in, sure_in), lambda: (
        f"{label}: {int((got_in != sure_in).sum())} queries miss points certainly inside the radius"))
    _require(bool(((dists * dists - d2).abs() <= band).all()), lambda: f"{label}: a distance beyond the f32 bound")
    return sure_in, undecided


def _range_check_common(label, res, radius: float, n_pad: int):
    """Per-query structure of range results: int32 ids, f32 ascending
    distances within the radius, no id twice. Returns the counts."""
    from tpu_knn_torch.methods.base import range_cap

    counts = np.asarray([len(r.ids) for r in res])
    for j, r in enumerate(res):
        _require(r.ids.dtype == np.int32 and r.dists.dtype == np.float32,
                 lambda: f"{label}: query {j} returned {r.ids.dtype} ids, {r.dists.dtype} distances")
        _require(bool((r.dists <= radius).all()) and bool((np.diff(r.dists) >= 0).all()),
                 lambda: f"{label}: query {j} has distances past the radius or out of order")
        _require(len(np.unique(r.ids)) == len(r.ids) and bool((r.ids >= 0).all()),
                 lambda: f"{label}: query {j} returned an id twice or a padding row")
    cap = range_cap(counts.max(), n_pad)
    print(f"[range] {label}: {len(res)} queries at radius {radius!r}: {int(counts.sum())} hits, "
          f"{int((counts >= 10).sum())} queries with 10 or more, largest count {int(counts.max())}, "
          f"cap {cap} of n_pad {n_pad}", flush=True)
    _require(cap <= n_pad // 8, lambda: f"{label}: the cap {cap} is not well below n_pad {n_pad}")
    return counts


def _timed_range(label, idx, queries, radius, smi):
    """Print the median of 5 host ms of range_query_batch, the peak device
    memory of one run, and the device ms of its two passes (CUDA events,
    mean of 3)."""
    import torch
    from tpu_knn_torch.methods import seq_search as SS
    from tpu_knn_torch.methods.base import range_cap

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = idx.range_query_batch(queries, radius)
    peak = torch.cuda.max_memory_allocated()
    med, tmin, tmax = _median_ms(lambda: idx.range_query_batch(queries, radius), 5)
    m = idx.method
    qenc = m.space.encode_queries(queries)
    cap = range_cap(max(len(r.ids) for r in res), m.data.ids.shape[0])
    stages = {
        "counts_pass": _cuda_ms(lambda: SS._range_counts_device(
            m.space, qenc, m.data, radius, m._chunk, m.precision), 3),
        "collect_pass": _cuda_ms(lambda: SS._range_collect_device(
            m.space, qenc, m.data, radius, cap, m._chunk, m.precision), 3),
    }
    print(f"[range] {label} range_query_batch Q={len(queries)}: median {med:.3f} ms of 5 (min {tmin:.3f}, "
          f"max {tmax:.3f}), {len(queries) / med * 1e3:.1f} qps; peak allocated {peak / 2**30:.3f} GiB; "
          f"device ms per pass (chunk {m._chunk}, cap {cap}) "
          f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}; {smi}", flush=True)


def _phase_range(idx, sidx, queries, qu8, corpus, cu8, d10, d8, smi):
    """Range search on phase 4's l2 index and phase 6's l2sqr_sift index."""
    import torch

    dev = torch.device("cuda", 0)
    radius = float(np.median(d10[:, K - 1]))
    res = idx.range_query_batch(queries, radius)
    n_pad = idx.method.data.ids.shape[0]
    counts = _range_check_common(f"l2 {N_CORPUS} rows", res, radius, n_pad)
    x_dev = torch.from_numpy(corpus).to(dev)
    sure_in, undecided = _range_check_l2(f"l2 {N_CORPUS} rows", res, torch.from_numpy(queries).to(dev), x_dev, radius)
    del x_dev
    n_und = int(undecided.sum())
    print(f"[oracle] range l2 {N_CORPUS} rows: every query returned all {int(sure_in.sum())} points certainly inside "
          f"the radius and none certainly outside; {n_und} points lie within the f32 bound of the radius "
          f"and {int(counts.sum() - sure_in.sum())} of them were returned", flush=True)
    _timed_range(f"l2 {N_CORPUS} x {DIM}", idx, queries, radius, smi)

    # l2sqr_sift: exact integer distances against the exact integer oracle
    r8 = float(np.median(d8[:, K - 1]))
    res8 = sidx.range_query_batch(qu8, r8)
    counts8 = _range_check_common(f"l2sqr_sift {N_CORPUS} rows", res8, r8, sidx.method.data.ids.shape[0])
    q8 = torch.from_numpy(qu8).to(dev).double()
    oracle = torch.zeros(len(res8), dtype=torch.int64, device=dev)
    for s in range(0, cu8.shape[0], 65536):
        xc = torch.from_numpy(cu8[s:s + 65536]).to(dev).double()
        d2 = (q8 * q8).sum(1, keepdim=True) + (xc * xc).sum(1)[None, :] - 2.0 * (q8 @ xc.T)
        oracle += (d2 <= r8).sum(1)
    _require(np.array_equal(oracle.cpu().numpy(), counts8), lambda: (
        f"l2sqr_sift range: counts differ from the integer oracle at "
        f"{int((oracle.cpu().numpy() != counts8).sum())} queries"))
    qi = torch.as_tensor(np.repeat(np.arange(len(res8)), counts8), device=dev)
    ids = torch.as_tensor(np.concatenate([r.ids for r in res8]).astype(np.int64), device=dev)
    x8 = torch.from_numpy(cu8).to(dev)
    exact = ((x8[ids].double() - q8[qi]) ** 2).sum(1)
    got = torch.as_tensor(np.concatenate([r.dists for r in res8]), device=dev).double()
    _require(torch.equal(exact, got) and bool((exact <= r8).all()), lambda: (
        "l2sqr_sift range: a returned distance is not its id's exact integer distance within the radius"))
    del x8
    one = sidx.range_query(qu8[0], r8)
    _require(np.array_equal(one.ids, res8[0].ids) and np.array_equal(one.dists, res8[0].dists),
             lambda: "l2sqr_sift range_query of one point differs from its range_query_batch row")
    print(f"[oracle] range l2sqr_sift {N_CORPUS} rows: counts equal to the exact integer oracle for every query, "
          f"every returned distance its id's exact distance, so the id sets are equal; range_query of "
          f"query 0 equal to its batch row", flush=True)
    _timed_range(f"l2sqr_sift {N_CORPUS} x {DIM} uint8", sidx, qu8, r8, smi)


def _phase_persist(idx, queries, d10, i10):
    """Save phase 4's index in both save modes, load it in both load modes,
    and hold knn results to those before the save, bit for bit."""
    import os
    import shutil
    import tempfile

    import torch
    from tpu_knn_torch import Index

    tmp = tempfile.mkdtemp(prefix="chip_smoke_persist_")
    try:
        for save_data in (True, False):
            path = os.path.join(tmp, f"ix_{save_data}")
            ts = time.perf_counter()
            idx.save(path, save_data=save_data)
            save_s = time.perf_counter() - ts
            sizes = {f: os.path.getsize(os.path.join(tmp, f)) for f in sorted(os.listdir(tmp))
                     if f.startswith(f"ix_{save_data}")}
            for load_data in (True, False):
                tl = time.perf_counter()
                back = Index.load(path, load_data=load_data, device="cuda")
                torch.cuda.synchronize()
                load_s = time.perf_counter() - tl
                d, i = back.knn_query_batch(queries, K)
                _require(np.array_equal(d, d10) and np.array_equal(i, i10), lambda: (
                    f"persist save_data={save_data} load_data={load_data}: results differ from before "
                    f"the save at {int((i != i10).sum())} ids, {int((d != d10).sum())} distances"))
                _require(back.method.data.vecs.device.type == "cuda", lambda: "loaded index is not on the card")
                da, ia = back.knn_query_batch_async(queries, K).result()
                _require(np.array_equal(da, d10) and np.array_equal(ia, i10),
                         lambda: "knn_query_batch_async differs from knn_query_batch")
                print(f"[persist] save_data={save_data} load_data={load_data}: save {save_s:.3f} s, "
                      f"load (read + rebuild on the card) {load_s:.3f} s, file bytes {sizes}; knn_query_batch "
                      f"and knn_query_batch_async k={K} bit-identical to before the save", flush=True)
                del back
                torch.cuda.empty_cache()
            for f in list(sizes):
                os.remove(os.path.join(tmp, f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: (ms, ms over the f32 kernel's 13.294 ms) of each wgmma tier's kernel
#: before the wgmma design (the mma.sync kernels), at the 1M shapes
OLD_RATIO = {"high": (6.669, 0.502), "bfloat16": (3.514, 0.264), "int8": (1.868, 0.141)}

N_ANGULAR = 1_183_514  # glove-100-angular's corpus (ann-benchmarks)
DIM_ANGULAR = 100


def _phase_angular(smi):
    """The scalar-product spaces at the glove-100-angular shape, the gold
    standard over that corpus and the metrics of the "high" tier."""
    import torch
    from tpu_knn_torch import Index, Params
    from tpu_knn_torch.eval import GoldStandard, per_query_metrics, summarize
    from tpu_knn_torch.eval.datasets import clustered
    from tpu_knn_torch.methods import seq_search as SS
    from tpu_knn_torch.ops import groupmin as GM
    from tpu_knn_torch.spaces.dense import ensure_cert_metadata

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    xall = clustered(N_ANGULAR + N_QUERIES, DIM_ANGULAR, seed=1)
    corpus, queries = xall[:N_ANGULAR], xall[N_ANGULAR:]
    print(f"[angular] data clustered({N_ANGULAR + N_QUERIES}, {DIM_ANGULAR}, seed=1) in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    aidx = Index("angulardist", Params(dim=DIM_ANGULAR), method="seq_search", device="cuda")
    tb = time.perf_counter()
    aidx.add_dense_batch(corpus)
    aidx.build_index()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    torch.cuda.reset_peak_memory_stats()
    GM.reset_launches()
    da, ia = aidx.knn_query_batch(queries, K)
    launches = dict(GM.launches)
    route = aidx.method.last_route
    print(f"[angular] build {build_s:.3f} s for {N_ANGULAR} x {DIM_ANGULAR} (normalized, padded to "
          f"{aidx.method.data.vecs.shape[1]} columns); first query: route {route}, launches {launches}; "
          f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    _require(route == "twopass" and launches["float32"] > 0,
             lambda: f"the angular path took the {route} route with launches {launches}")
    _require(np.isfinite(da).all() and (np.diff(da, axis=1) >= 0).all() and (da >= 0).all()
             and (da <= np.pi).all(), lambda: "angular distances not finite, ascending and in [0, pi]")
    med, tmin, tmax = _median_ms(lambda: aidx.knn_query_batch(queries, K))
    print(f"[angular] knn_query_batch Q={N_QUERIES} k={K} over {N_ANGULAR} x {DIM_ANGULAR}: median "
          f"{med:.3f} ms of 7 (min {tmin:.3f}, max {tmax:.3f}), {N_QUERIES / med * 1e3:.1f} qps on {smi}",
          flush=True)
    stages, qenc = _breakdown(aidx, queries, K)
    print("[angular breakdown] device ms per stage: "
          + json.dumps({k: round(v, 4) for k, v in stages.items()}), flush=True)

    # the f32 and bf16x3 kernels at these shapes: scale -1, zero q_term, x_term = padding only
    data = aidx.method.data
    qk, qtk, xtk, scale = SS._kernel_inputs(aidx.space, qenc, data)
    _require(scale == -1.0 and xtk is data.extra["pad"] and not bool(qtk.any()),
             lambda: "angular kernel inputs are not (scale -1, q_term 0, x_term pad)")
    ensure_cert_metadata(data)
    f32 = None
    for tier in ("float32", "high", "bfloat16"):
        out = GM.fused_groupmin(qk, data.vecs, qtk, xtk, scale, precision=tier)
        ref = GM.fused_groupmin_reference(qk, data.vecs, qtk, xtk, scale, precision=tier)
        bound, mag = _groupmin_bound(qk, data.vecs, qtk, xtk, scale)
        # pad groups hold 1e30: compare the real groups
        real = data.count // 128
        diff = (out.double() - ref.double()).abs()[:, :real]
        rel = float((diff / mag[:, :real]).max())
        lim = float((diff / (2 * bound[:, :real])).max()) if tier == "float32" else rel / 1e-5
        eps_msg = ""
        if tier == "float32":
            f32 = out
        else:
            eps = SS._pass1_eps(qk, data, scale, tier).double()
            ratio = float(((out.double() - f32.double()).abs()[:, :real].amax(dim=1) / eps).max())
            _require(ratio <= 1.0, lambda: f"{tier} kernel beyond eps of the f32 kernel at the angular shapes: {ratio}")
            eps_msg = f"; max over queries of max_g |kernel - f32 kernel| / eps {ratio:.3g}"
        ms = _cuda_ms(lambda: GM.fused_groupmin(qk, data.vecs, qtk, xtk, scale, precision=tier), 10)
        plain_ms = _cuda_ms(lambda: GM.fused_groupmin_reference(qk, data.vecs, qtk, xtk, scale,
                                                                precision=tier), 3)
        bms, by = _bound_ms(tier, qk, data.vecs)
        print(f"[kernel] {tier} at the angular shapes Q={qk.shape[0]} N={data.vecs.shape[0]} "
              f"D={data.vecs.shape[1]}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; max |kernel - plain| "
              f"{float(diff.max()):.4g} ({rel:.3g} of the magnitude), {lim:.3g} of the limit "
              f"({'2x the f32 bound' if tier == 'float32' else '1e-5 of the magnitude'}){eps_msg}; bound "
              f"{bms:.3f} ms ({by}), {bms / ms:.1%} of it; {smi}", flush=True)
        _require(lim <= 1.0 and bool(torch.isfinite(out).all()),
                 lambda: f"{tier} kernel vs plain at the angular shapes: {lim} of the limit")
    del out, ref, bound, mag, diff, f32

    # float64 oracle on the cosines of the normalized rows the index stores
    x_dev = data.vecs[:data.count]
    q_dev = qenc["q"][:N_QUERIES]
    # arccos has unbounded slope at 1: hold cos(angle), not the angle, to the oracle
    _check_dot_oracle("angulardist k=10", ia, q_dev, x_dev, K, da, np.cos)
    torch.cuda.reset_peak_memory_stats()
    da100, ia100 = aidx.knn_query_batch(queries, 100)
    print(f"[memory] angular peak allocated during the k=100 query "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    _check_dot_oracle("angulardist k=100", ia100, q_dev, x_dev, 100)
    del da100, ia100

    # the gold standard over the same corpus and space, and its cache
    import os
    import tempfile

    gold = GoldStandard(aidx.space, aidx.store)
    gd, gi = gold.compute_knn(queries, K)
    _require(np.array_equal(gd, da) and np.array_equal(gi, ia),
             lambda: "GoldStandard.compute_knn differs from the index's results")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gold_") as tmp:
        gold.save_cache(os.path.join(tmp, "gold"))
        cd, ci = GoldStandard.load_cache(os.path.join(tmp, "gold"))
    _require(np.array_equal(cd, gd) and np.array_equal(ci, gi) and cd.dtype == gd.dtype
             and ci.dtype == gi.dtype, lambda: "gold-standard cache round trip is not exact")
    print(f"[gold] GoldStandard.compute_knn(queries, {K}) equal to the index's results; cache round "
          f"trip exact", flush=True)
    del gold

    # pass1Precision "high" on the same index: bit-identical to the f32 tier
    aidx.build_index(Params(pass1Precision="high"))
    GM.reset_launches()
    dh, ih = aidx.knn_query_batch(queries, K)
    lh = dict(GM.launches)
    m = aidx.method
    print(f"[angular high] route {m.last_route}, launches {lh}, certified {m.last_certified:.6f}, "
          f"redone blocks {m.last_redone_blocks} of {-(-N_QUERIES // SS._CERT_QBLK)}", flush=True)
    _require(m.last_route == "twopass" and lh["high"] > 0,
             lambda: f"the angular high path took the {m.last_route} route with launches {lh}")
    _same_results(f"angular high k={K}", dh, ih, da, ia)
    medh, tminh, tmaxh = _median_ms(lambda: aidx.knn_query_batch(queries, K))
    print(f"[angular high] knn_query_batch Q={N_QUERIES} k={K}: median {medh:.3f} ms of 7 (min "
          f"{tminh:.3f}, max {tmaxh:.3f}); f32 tier {med:.3f} ms; {smi}", flush=True)
    summ = summarize(per_query_metrics(gd, gi, dh, ih))
    print(f"[metrics] high tier against the gold standard: {json.dumps(summ)}", flush=True)
    _require(summ["recall"] == 1.0 and summ["number_closer"] == 0.0,
             lambda: f"high tier metrics against the gold standard: {summ}")
    del aidx, m, data, qenc, qk, qtk, xtk, x_dev, q_dev
    torch.cuda.empty_cache()

    # cosinesimil on the same data: the same ids as angulardist, 1 - cos distances
    cidx = Index("cosinesimil", Params(dim=DIM_ANGULAR), method="seq_search", device="cuda")
    cidx.add_dense_batch(corpus)
    GM.reset_launches()
    dc, ic = cidx.knn_query_batch(queries, K)
    _require(cidx.method.last_route == "twopass" and GM.launches["float32"] > 0,
             lambda: f"cosinesimil took the {cidx.method.last_route} route, launches {GM.launches}")
    cdata = cidx.method.data
    cq = cidx.space.encode_queries(queries)["q"]
    _check_dot_oracle("cosinesimil k=10", ic, cq, cdata.vecs[:cdata.count], K, dc, lambda d: 1.0 - d)
    same = ic == ia
    xo = cdata.vecs[torch.as_tensor(np.where(same, ic, ia), device=dev).long()].double()
    xc = cdata.vecs[torch.as_tensor(ic, device=dev).long()].double()
    gap = ((xo - xc) * cq.double()[:, None, :]).sum(-1).abs().cpu().numpy()
    tie = 2 * (DIM + 2) * U * 1.01
    _require(bool((same | (gap <= tie)).all()), lambda: "cosinesimil ids differ from angulardist's beyond ties")
    print(f"[cosine] cosinesimil k={K}: ids equal to angulardist's at {int(same.sum())}/{same.size} slots, "
          f"the rest within the f32 bound of each other's cosine", flush=True)
    del cidx, cdata, cq, xo, xc
    torch.cuda.empty_cache()

    # negdotprod on the raw rows
    nidx = Index("negdotprod", Params(dim=DIM_ANGULAR), method="seq_search", device="cuda")
    nidx.add_dense_batch(corpus)
    GM.reset_launches()
    dn, in_ = nidx.knn_query_batch(queries, K)
    _require(nidx.method.last_route == "twopass" and GM.launches["float32"] > 0,
             lambda: f"negdotprod took the {nidx.method.last_route} route, launches {GM.launches}")
    ndata = nidx.method.data
    nq = nidx.space.encode_queries(queries)["q"]
    _check_dot_oracle("negdotprod k=10", in_, nq, ndata.vecs[:ndata.count], K, dn, np.negative)
    del nidx, ndata, nq
    torch.cuda.empty_cache()


def _phase_precision(corpus, queries, smi):
    """``precision`` of the single-pass scan (space.block's matmul tier)
    on phase 5's 3000-row index."""
    import torch
    from tpu_knn_torch import Index, Params
    from tpu_knn_torch.eval import per_query_metrics, summarize

    dev = torch.device("cuda", 0)
    q_dev, x_dev = torch.from_numpy(queries).to(dev), torch.from_numpy(corpus[:3000]).to(dev)
    out = {}
    for precision in ("float32", "high", "bfloat16"):
        pidx = Index("l2", Params(dim=DIM), method="seq_search", device="cuda")
        pidx.add_dense_batch(corpus[:3000])
        pidx.build_index(Params(precision=precision))
        out[precision] = pidx.knn_query_batch(queries, K)
        _require(pidx.method.last_route == "single", lambda: f"precision {precision}: not the single-pass route")
    # bf16x3 drops lo.lo and the second-level residuals: at most 3 * 2^-18 of
    # |q||x| (with headroom), plus the f32 sums of its three products
    high_rel = 3 * 2.0**-18 * 1.02 + 2 * (DIM + 2) * U
    _check_against_oracle("precision high, single pass, 3000 rows", out["high"][1], out["high"][0],
                          q_dev, x_dev, K, dot_rel=high_rel)
    gd, gi = out["float32"]
    bd, bi = out["bfloat16"]
    summ = summarize(per_query_metrics(gd, gi, bd, bi, check_invariant=False))
    print(f"[precision] bfloat16, single pass, 3000 rows, k={K}: against the f32 gold "
          f"{json.dumps(summ)} (approximate by design; distances at the bf16 tier)", flush=True)
    _require(summ["recall"] > 0.0, lambda: f"bfloat16 recall {summ['recall']}")


def _phase_nan(smi):
    """A corpus row that holds +inf, 20,000 x 16 rows, row 7 column 3, k=5,
    through Index(device="cuda") on the two-pass route. On the CPU both
    packages return that row first with distance NaN for a query whose norm
    identity gives inf - inf (the plain pass 1 carries the NaN into the
    group's min, and smallest_k ranks NaN first). The kernels' min carries
    NaN too (csrc/min_nan.cuh): the f32 kernel's group mins equal its plain
    version's, with NaN in the same cells, and every such query returns row
    7 first through Index(device="cuda"), as on the CPU."""
    import torch
    from tpu_knn_torch import Index, Params
    from tpu_knn_torch.ops import groupmin as GM

    rng = np.random.default_rng(0)
    x = rng.standard_normal((20_000, 16)).astype(np.float32)
    x[7, 3] = np.inf
    q = rng.standard_normal((64, 16)).astype(np.float32)
    idx = Index("l2", Params(dim=16), method="seq_search", device="cuda")
    idx.add_dense_batch(x)
    GM.reset_launches()
    d, i = idx.knn_query_batch(q, 5)
    _require(idx.method.last_route == "twopass" and GM.launches["float32"] > 0,
             lambda: f"NaN input: route {idx.method.last_route}, launches {dict(GM.launches)}")
    data = idx.method.data
    qe = idx.space.encode_queries(q)
    xt = (data.extra["pad"] + data.row_term).contiguous()
    k_out = GM.fused_groupmin(qe["q"], data.vecs, qe["q_term"].contiguous(), xt, -2.0)
    p_out = GM.fused_groupmin_reference(qe["q"], data.vecs, qe["q_term"].contiguous(), xt, -2.0)
    # queries with q[3] > 0 give |x|^2 - 2 q.x = inf - inf at row 7; the others give +inf there
    want = q[:, 3] > 0
    kn, pn = torch.isnan(k_out[:, 0]).cpu().numpy(), torch.isnan(p_out[:, 0]).cpu().numpy()
    first_nan = np.isnan(d[:, 0]) & (i[:, 0] == 7)
    others = ~torch.isnan(p_out)
    _require(torch.equal(torch.isnan(k_out), torch.isnan(p_out)),
             lambda: f"NaN input: the kernel's mins are NaN in {int(torch.isnan(k_out).sum())} cells, the plain "
                     f"version's in {int(torch.isnan(p_out).sum())}, {int((torch.isnan(k_out) != torch.isnan(p_out)).sum())} differ")
    _require(torch.equal(k_out[others], p_out[others]) or
             bool(((k_out[others] - p_out[others]).abs() <= 1e-4 * p_out[others].abs()).all()),
             lambda: "NaN input: kernel and plain differ beyond rounding where neither is NaN")
    _require(not np.isnan(d[:, 1:]).any() and (np.isnan(d[:, 0]) == first_nan).all(),
             lambda: "NaN input: a NaN distance that is not row 7 in first place")
    _require(np.array_equal(first_nan, want) and np.array_equal(pn, want),
             lambda: f"NaN input: {int(first_nan.sum())} of the {int(want.sum())} NaN queries return row 7 first")
    print(f"[nan] row 7 holds +inf, 20,000 x 16, k=5, two-pass on the card: {int(want.sum())} of 64 queries "
          f"have inf - inf there; group 0's min is NaN for {int(pn.sum())} of them in the plain version "
          f"(torch.min) and for {int(kn.sum())} in the f32 kernel (min.NaN.f32), NaN in the same cells; "
          f"knn_query_batch returns row 7 first with distance NaN for {int(first_nan.sum())} queries "
          f"(the CPU path and tpu_knn: all {int(want.sum())}); {smi}", flush=True)
    return {"queries": int(want.sum()), "plain_nan": int(pn.sum()), "kernel_nan": int(kn.sum()),
            "returned_nan_first": int(first_nan.sum())}


def _recall_at(ids, gold, k: int) -> float:
    return float(np.mean([len(set(a[:k]) & set(b[:k])) / k for a, b in zip(ids, gold)]))


def _check_exact_distances(label, d, ids, q_dev, x_dev):
    """Every returned distance against the float64 distance of that id
    (rtol 5e-3, atol 1e-5: the l2 norm-identity floor)."""
    import torch

    pos = torch.from_numpy(ids.astype(np.int64)).to(x_dev.device)
    _require(bool((pos >= 0).all()), lambda: f"{label}: an id of -1")
    ref = (x_dev[pos].double() - q_dev.double()[:, None, :]).norm(dim=2).cpu().numpy()
    bad = np.abs(d - ref) > 1e-5 + 5e-3 * np.abs(ref)
    _require(not bad.any(), lambda: f"{label}: {int(bad.sum())} distances off their f64 value, worst "
                                    f"{float(np.abs(d - ref).max())}")
    return float(np.abs(d - ref).max())


def _async_batches(n: int = 8):
    """Phase 22's n distinct batches of N_QUERIES sift_like queries (seed 22)."""
    from tpu_knn_torch.eval.datasets import sift_like

    x = sift_like(n * N_QUERIES, DIM, seed=22)
    return [x[i * N_QUERIES:(i + 1) * N_QUERIES] for i in range(n)]


def _async_runs(tag: str, idx, batches, k: int, smi, tier: str | None = None) -> dict:
    """Phase 22 (b) and (c) on one index: the batches all in flight at once,
    each result bit-identical to knn_query_batch of the same batch (the
    group-min launches of ``tier`` counted over the in-flight run, one a
    batch), then the in-flight run against the same calls made serially,
    in turns (in flight, serial, serial, in flight), three rounds. Returns
    the numbers it printed."""
    import torch
    from tpu_knn_torch.ops import groupmin as GM

    want = [idx.knn_query_batch(b, k) for b in batches]
    torch.cuda.synchronize()
    GM.reset_launches()
    futs = [idx.knn_query_batch_async(b, k) for b in batches]
    got = [f.result() for f in futs]
    launched = dict(GM.launches)
    same = [bool(np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])) for g, w in zip(got, want)]
    _require(all(same), lambda: f"[async] {tag}: in-flight results differ from knn_query_batch: {same}")
    if tier is not None:
        _require(launched[tier] == len(batches),
                 lambda: f"[async] {tag}: {launched} group-min launches for {len(batches)} batches in flight")

    def in_flight():
        for f in [idx.knn_query_batch_async(b, k) for b in batches]:
            f.result()

    def serial():
        for b in batches:
            idx.knn_query_batch(b, k)

    times = {"in_flight": [], "serial": []}
    for _ in range(3):
        for who in ("in_flight", "serial", "serial", "in_flight"):
            ts = time.perf_counter()
            (in_flight if who == "in_flight" else serial)()
            times[who].append((time.perf_counter() - ts) * 1e3)
    nq = sum(len(b) for b in batches)
    med = {who: statistics.median(t) for who, t in times.items()}
    qps = {who: nq / m * 1e3 for who, m in med.items()}
    print(f"[async] {tag}: {len(batches)} batches of {len(batches[0])} queries in flight, each bit-identical to "
          f"knn_query_batch; launches over the in-flight run {launched}; ms of the {len(batches)} batches in turns "
          f"(in flight, serial, serial, in flight) x 3: in flight {[round(t, 3) for t in times['in_flight']]}, "
          f"serial {[round(t, 3) for t in times['serial']]}; median in flight {med['in_flight']:.3f} ms "
          f"({qps['in_flight']:.1f} qps), serial {med['serial']:.3f} ms ({qps['serial']:.1f} qps), ratio "
          f"{med['in_flight'] / med['serial']:.4f}; {smi}", flush=True)
    return {"launches": launched.get(tier) if tier else None, "ms_in_flight": times["in_flight"],
            "ms_serial": times["serial"], "qps_in_flight": qps["in_flight"], "qps_serial": qps["serial"]}


def _phase_async_scan(smi, idx, queries, d10, i10, sync_ms: float) -> dict:
    """Phase 22 (a)-(c) on phase 4's 1M l2 seq_search index. (a) dispatches
    twice: the first call of the process also starts the card's worker
    (its thread and its stream), the second finds it idle."""
    import torch

    dispatch_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        fut = idx.knn_query_batch_async(queries, K)
        dispatch_ms.append((time.perf_counter() - ts) * 1e3)
        job = idx.method._inflight[-1]
        # the worker records the batch's event once it has queued the batch
        early = not job.done.is_set() or not job.event.query()
        d, i = fut.result()
        _require(early, lambda: "[async] (a) knn_query_batch_async returned after its batch had completed")
        _require(np.array_equal(d, d10) and np.array_equal(i, i10),
                 lambda: "[async] (a) the future differs from phase 4's knn_query_batch")
    print(f"[async] (a) 1M l2 seq_search, Q={N_QUERIES} k={K}: knn_query_batch_async returned in "
          f"{dispatch_ms[1]:.3f} ms ({dispatch_ms[0]:.3f} ms the first time, which starts the worker), each "
          f"before its batch's event completed (synchronous wall, phase 4 median: {sync_ms:.3f} ms); the results "
          f"bit-identical to phase 4's; {smi}", flush=True)
    out = {"dispatch_ms": dispatch_ms[1], "first_dispatch_ms": dispatch_ms[0], "sync_ms": sync_ms}
    out.update(_async_runs("(b, c) 1M l2 seq_search", idx, _async_batches(), K, smi, tier="float32"))
    return out


def _phase_hnsw(smi):
    """The default method at the repo's own HNSW cell (100,000 x 128
    sift_like rows, M=16, efConstruction=200, waveSize=1024; 2048 queries,
    k=10): build, check_graph, recall and qps against GoldStandard over
    efSearch, exact distances, range raises, save and load on the card, the
    replicated neighbour stores, determinism at 10,000 rows, and l2sqr_sift
    and angulardist at 20,000 rows. Returns the numbers it printed."""
    import os
    import shutil
    import tempfile

    import torch
    from tpu_knn_torch import DataKind, DistKind, Index, Params
    from tpu_knn_torch.core.errors import SpaceIncompatibleError
    from tpu_knn_torch.eval import GoldStandard
    from tpu_knn_torch.eval.datasets import clustered, sift_like
    from tpu_knn_torch.ops import graph as G
    from tpu_knn_torch.ops import groupmin as GM

    n, nq, k = 100_000, N_QUERIES, K
    xall = sift_like(n + nq, DIM, seed=0)
    corpus, queries = xall[:n], xall[n:]
    zero = {"self_links": 0, "dup_links": 0, "oob_links": 0}
    out = {}

    idx = Index("l2", Params(dim=DIM), device="cuda")  # no method=: the default
    _require(idx.get_method() == "hnsw", lambda: f"the default method is {idx.get_method()!r}")
    idx.add_dense_batch(corpus)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    G.reset_counters()
    tb = time.perf_counter()
    idx.build_index(Params(M=16, efConstruction=200, waveSize=1024))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    m = idx.method
    chk = m.check_graph()
    deg = m.degree_distribution()
    out.update(build_s=build_s, build_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"[hnsw] build {n} x {DIM}, M=16 efConstruction=200 waveSize=1024 (buildAlgo auto -> waves, "
          f"construction store {bool(m.construction_store) and m._cstore_ok()}): {build_s:.2f} s, peak allocated "
          f"{out['build_peak_gib']:.3f} GiB, {len(m._upper) + 1} levels, mean level-0 degree "
          f"{float(np.average(np.arange(deg.shape[0]), weights=deg)):.2f}, check_graph {chk}, beam iterations "
          f"{G.counters['beam_iters']} with {G.counters['beam_syncs']} syncs; {smi}", flush=True)
    _require(chk == zero, lambda: f"check_graph after the 100k build: {chk}")
    _require(m.data.vecs.device.type == "cuda" and m.graph["level0"].device.type == "cuda",
             lambda: "the built index is not on the card")
    _require(m._qenc_all is None, lambda: "construction state kept after the build")

    GM.reset_launches()
    gold = GoldStandard(idx.space, idx.store)
    gd, gi = gold.compute_knn(queries, k)
    _require(GM.launches["float32"] > 0 and gold.method.last_route == "twopass",
             lambda: f"the gold standard did not run the f32 kernel: {dict(GM.launches)}")
    q_dev = torch.from_numpy(queries).to("cuda")
    x_dev = torch.from_numpy(corpus).to("cuda")

    def sweep(label, index, efs):
        rows = {}
        for ef in efs:
            index.set_query_time_params(Params(efSearch=ef))
            torch.cuda.reset_peak_memory_stats()
            d, i = index.knn_query_batch(queries, k)  # warm
            peak = torch.cuda.max_memory_allocated() / 2**30
            G.reset_counters()
            index.knn_query_batch(queries, k)
            counts = dict(G.counters)
            best = _median_ms(lambda: index.knn_query_batch(queries, k), reps=3)[1]
            _require(d.shape == (nq, k) and i.shape == (nq, k) and np.isfinite(d).all()
                     and (np.diff(d, axis=1) >= 0).all(), lambda: f"{label} efSearch={ef}: bad result")
            err = _check_exact_distances(f"{label} efSearch={ef}", d, i, q_dev, x_dev)
            rows[ef] = dict(recall=_recall_at(i, gi, k), ms=best, qps=nq / best * 1e3, d=d, i=i)
            print(f"[hnsw] {label} efSearch={ef}: recall@{k} {rows[ef]['recall']:.4f}, best of 3 {best:.2f} ms, "
                  f"{rows[ef]['qps']:.0f} qps, peak {peak:.3f} GiB; beam iterations {counts['beam_iters']} with "
                  f"{counts['beam_syncs']} syncs, descent steps {counts['descent_steps']} with "
                  f"{counts['descent_syncs']} syncs; max |d - f64| {err:.3g}; {smi}", flush=True)
        return rows

    plain = sweep("l2", idx, (10, 14, 20, 50, 100, 200))
    _require(plain[20]["recall"] >= 0.95 and plain[100]["recall"] >= 0.99,
             lambda: f"recall@10 {plain[20]['recall']} at efSearch=20, {plain[100]['recall']} at 100")
    dup = [int((np.sort(r["i"], axis=1)[:, 1:] == np.sort(r["i"], axis=1)[:, :-1]).sum()) for r in plain.values()]
    _require(sum(dup) == 0, lambda: f"duplicate ids in results: {dup}")
    out["search"] = {ef: {a: r[a] for a in ("recall", "ms", "qps")} for ef, r in plain.items()}

    # ---- phase 22 (d) and (e): async on this index ----
    idx.set_query_time_params(Params(efSearch=20))
    out["async"] = _async_runs("(d) hnsw 100k efSearch=20", idx, _async_batches(), k, smi)
    for how in ("method", "Index"):
        fut = idx.knn_query_batch_async(queries, k)
        job = idx.method._inflight[-1]
        in_flight = not job.done.is_set()
        if how == "method":  # no drain at this level: the batch may still be queued
            idx.method.set_query_time_params(Params(efSearch=100))
        else:
            idx.set_query_time_params(Params(efSearch=100))
        da, ia = fut.result()
        _require(np.array_equal(da, plain[20]["d"]) and np.array_equal(ia, plain[20]["i"]),
                 lambda: f"[async] (e) a batch dispatched at efSearch=20 changed with {how}.set_query_time_params")
        print(f"[async] (e) dispatched at efSearch=20, then {how}.set_query_time_params(efSearch=100) with the "
              f"batch {'still in flight' if in_flight else 'already run'}: the result equals the synchronous "
              f"efSearch=20 result", flush=True)
        idx.set_query_time_params(Params(efSearch=20))

    try:
        idx.range_query(queries[0], 1.0)
        raised = False
    except SpaceIncompatibleError:
        raised = True
    _require(raised, lambda: "range_query on hnsw did not raise SpaceIncompatibleError")

    # save -> load on the card -> identical answers
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hnsw_")
    try:
        path = os.path.join(tmp, "hnsw")
        ts = time.perf_counter()
        idx.save(path)
        save_s = time.perf_counter() - ts
        tl = time.perf_counter()
        back = Index.load(path, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - tl
        back.set_query_time_params(Params(efSearch=50))
        db, ib = back.knn_query_batch(queries, k)
        _require(np.array_equal(db, plain[50]["d"]) and np.array_equal(ib, plain[50]["i"]),
                 lambda: "results after save and load differ")
        _require(back.get_method() == "hnsw" and back.method.graph["level0"].device.type == "cuda"
                 and torch.equal(back.method.graph["level0"], m.graph["level0"]),
                 lambda: "the loaded graph differs or is not on the card")
        sizes = {f: os.path.getsize(os.path.join(tmp, f)) for f in sorted(os.listdir(tmp))}
        print(f"[hnsw] save {save_s:.3f} s, Index.load(device='cuda') {load_s:.3f} s, files {sizes}: ids and "
              f"distances at efSearch=50 identical to before the save", flush=True)
        out.update(save_s=save_s, load_s=load_s)
        del back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # replicateNeighbors=1 at the 100k cell: the store is made lazily from the
    # graph at the first query, so this sets the built method's two parameters
    # instead of building the same graph twice more; the parameters' own way
    # in, through build_index, is held on the CPU (tests/test_torch_hnsw.py)
    # and at SIFT-1M in phase 16
    base_mem = idx.memory_usage_bytes()
    for dtype in ("bfloat16", "int8"):
        m.replicate_neighbors, m.nbr_store_dtype, m._nbr_store = 1, dtype, None
        torch.cuda.reset_peak_memory_stats()
        rep = sweep(f"replicateNeighbors=1 {dtype}", idx, (20, 100))
        store = m._nbr_store[1]
        grown = idx.memory_usage_bytes() - base_mem
        _require(grown == store.nbytes and tuple(store.shape) == (m.data.ids.shape[0], 32, DIM),
                 lambda: f"memory_usage_bytes grew by {grown}, the store holds {store.nbytes}")
        for ef in (20, 100):
            _require(abs(rep[ef]["recall"] - plain[ef]["recall"]) <= 0.01,
                     lambda: f"{dtype} store recall {rep[ef]['recall']} against {plain[ef]['recall']} at {ef}")
        print(f"[hnsw] {dtype} store {store.nbytes / 2**30:.3f} GiB, counted by memory_usage_bytes "
              f"({base_mem / 2**30:.3f} -> {(base_mem + grown) / 2**30:.3f} GiB), peak while it was made and "
              f"searched {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
        out[f"store_{dtype}"] = {ef: {a: r[a] for a in ("recall", "ms", "qps")} for ef, r in rep.items()}
    m.replicate_neighbors, m._nbr_store = 0, None
    del idx, m, gold, x_dev
    torch.cuda.empty_cache()

    # determinism at 10,000 x 128 (cut from 20,000: the whole script took 1292.7 s of command
    # on a slow host, NVIDIA H100 80GB HBM3, 700 W): same seed, same graph, on the card
    n2 = 10_000
    det_params = dict(M=8, efConstruction=60, waveSize=256, seed=11)

    def det_build(**kw):
        ix = Index("l2", Params(dim=DIM), device="cuda")
        ix.add_dense_batch(corpus[:n2])
        t0 = time.perf_counter()
        ix.build_index(Params(det_params, **kw))
        torch.cuda.synchronize()
        return ix, time.perf_counter() - t0

    (a, sa), (b, sb) = det_build(), det_build()
    same = torch.equal(a.method.graph["level0"], b.method.graph["level0"]) and len(a.method._upper) > 0 and all(
        torch.equal(ua, ub) for ua, ub in zip(a.method._upper, b.method._upper))
    _require(same, lambda: "two builds from one seed gave different graphs")
    qa = corpus[:64]
    (da, ia), (db, ib) = a.knn_query_batch(qa, 5), b.knn_query_batch(qa, 5)
    _require(np.array_equal(da, db) and np.array_equal(ia, ib), lambda: "identical graphs answer differently")
    qo = corpus[10:42].copy()
    _, fwd = a.knn_query_batch(qo, 5)
    _, rev = a.knn_query_batch(qo[::-1].copy(), 5)
    _require(np.array_equal(fwd, rev[::-1]), lambda: "a query's result depends on its place in the batch")
    p, sp = det_build(post=1)
    chk = p.method.check_graph()
    _require(chk == zero and a.method.check_graph() == zero, lambda: f"check_graph with post=1: {chk}")
    print(f"[hnsw] determinism, {n2} x {DIM}, {det_params}: two builds ({sa:.2f} s, {sb:.2f} s) give equal "
          f"level0 and {len(a.method._upper)} upper levels and identical results; a reversed batch gives the "
          f"reversed results; post=1 builds in {sp:.2f} s with check_graph {chk}; {smi}", flush=True)
    del a, b, p

    # the other dense spaces over 20,000 rows; waveSize=1024 > n/64, so the head of the schedule ramps
    small = Params(M=16, efConstruction=100, waveSize=1024)
    cu8 = np.rint(corpus[:n2]).astype(np.uint8)
    ang = clustered(n2 + 256, 100, seed=1)
    cases = (
        ("l2sqr_sift", dict(data_type=DataKind.UINT8, dist_type=DistKind.INT), None, cu8,
         np.rint(queries[:256]).astype(np.uint8)),
        ("angulardist", {}, Params(dim=100), ang[:n2], ang[n2:]),
    )
    for name, kw, sparams, xs, qs in cases:
        ix = Index(name, sparams, device="cuda", **kw)
        add = ix.add_uint8_batch if name == "l2sqr_sift" else ix.add_dense_batch
        add(xs)
        t0 = time.perf_counter()
        ix.build_index(small)
        torch.cuda.synchronize()
        bs = time.perf_counter() - t0
        ix.set_query_time_params(Params(efSearch=100))
        chk = ix.method.check_graph()
        ds, is_ = ix.knn_query_batch(xs[:256], k)
        self_first = float(np.mean(is_[:, 0] == np.arange(256)))
        _, g_i = GoldStandard(ix.space, ix.store).compute_knn(qs, k)
        rec = _recall_at(ix.knn_query_batch(qs, k)[1], g_i, k)
        print(f"[hnsw] {name} {n2} rows, {small.as_dict()}: build {bs:.2f} s, check_graph {chk}, stores "
              f"eligible {ix.method._cstore_ok()}, self-query first {self_first:.4f} (largest self distance "
              f"{float(ds[:, 0].max()):.3g}), recall@{k} at efSearch=100 {rec:.4f}; {smi}", flush=True)
        _require(chk == zero and self_first == 1.0 and rec >= 0.9,
                 lambda: f"{name}: check_graph {chk}, self-query first {self_first}, recall {rec}")
        if name == "l2sqr_sift":
            _require(bool((ds[:, 0] == 0).all()) and bool((ds == np.rint(ds)).all()),
                     lambda: "l2sqr_sift: a self distance that is not exactly 0, or a non-integer distance")
        out[name] = dict(build_s=bs, recall=rec)
        del ix
    torch.cuda.empty_cache()
    return out


def _phase_nnd(smi, corpus, queries, i10):
    """The default index at SIFT-1M, built by NN-descent (bench.py's
    Params1M, buildAlgo auto), and the 10,000-row side cells. Returns the
    numbers it printed."""
    import torch
    from tpu_knn_torch import DataKind, DistKind, Index, Params
    from tpu_knn_torch.eval import GoldStandard
    from tpu_knn_torch.eval.datasets import clustered, sift_like
    from tpu_knn_torch.ops import graph as G
    from tpu_knn_torch.ops import nndescent as TN
    from tpu_knn_torch.tools.hnsw_profile import nnd_log_summary
    from tpu_knn_torch.utils import logging as L

    n, nq, k = corpus.shape[0], queries.shape[0], K
    zero = {"self_links": 0, "dup_links": 0, "oob_links": 0}
    lines: list = []
    L.LOGGER.set_custom(lambda level, msg: lines.append(msg))
    try:
        idx = Index("l2", Params(dim=DIM), device="cuda")  # the default method
        idx.add_dense_batch(corpus)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        G.reset_counters()
        params1m = dict(M=16, efConstruction=100, waveSize=1024, replicateNeighbors=1, nbrStoreDtype="int8")
        tb = time.perf_counter()
        idx.build_index(Params(params1m, nndProfile=1))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - tb
    finally:
        L.LOGGER.set_stderr()
    m = idx.method
    peak = torch.cuda.max_memory_allocated() / 2**30
    phases, sweeps, repaired = nnd_log_summary(lines)
    chk = m.check_graph()
    unreached = int((~TN._reach_from_host(m.graph["level0"].cpu().numpy(), m._entry)[:n]).sum())
    print(f"[nnd] build {n} x {DIM}, bench.py's Params1M {params1m} (buildAlgo auto -> "
          f"{m._resolve_build_algo(n)}) with nndProfile=1: {build_s:.2f} s, peak allocated {peak:.3f} GiB, "
          f"{len(m._upper) + 1} levels, check_graph {chk}, {unreached} nodes unreached from the entry; phase walls "
          f"(s, a device sync at each) {json.dumps(phases)}; descent updates per sweep {sweeps}; repaired nodes per "
          f"link {repaired}; beam iterations {G.counters['beam_iters']}, descent steps "
          f"{G.counters['descent_steps']}; {smi}", flush=True)
    _require(m._resolve_build_algo(n) == "nndescent" and len(phases) >= 10 and sweeps,
             lambda: f"the 1M default build did not run NN-descent: phases {phases}")
    _require(chk == zero and unreached == 0, lambda: f"1M NN-descent graph: check_graph {chk}, unreached {unreached}")
    _require(m.graph["level0"].device.type == "cuda" and m._qenc_all is None,
             lambda: "the 1M graph is not on the card, or construction state was kept")

    q_dev = torch.from_numpy(queries).to("cuda")
    x_dev = torch.from_numpy(corpus).to("cuda")
    rows = {}
    for ef in (10, 11, 12, 13, 14, 20, 50):  # bench.py's efSearch set at 1M
        idx.set_query_time_params(Params(efSearch=ef))
        d, i = idx.knn_query_batch(queries, k)  # warm; the int8 neighbour store is made at the first
        G.reset_counters()
        idx.knn_query_batch(queries, k)
        counts = dict(G.counters)
        best = _median_ms(lambda: idx.knn_query_batch(queries, k), reps=3)[1]
        _require(d.shape == (nq, k) and np.isfinite(d).all() and (np.diff(d, axis=1) >= 0).all(),
                 lambda: f"1M NN-descent efSearch={ef}: bad result")
        err = _check_exact_distances(f"1M NN-descent efSearch={ef}", d, i, q_dev, x_dev)
        rows[ef] = dict(recall=_recall_at(i, i10, k), ms=best, qps=nq / best * 1e3)
        print(f"[nnd] 1M efSearch={ef}: recall@{k} {rows[ef]['recall']:.4f} (against phase 4's exact ids), best of 3 "
              f"{best:.2f} ms, {rows[ef]['qps']:.0f} qps; beam iterations {counts['beam_iters']}, descent steps "
              f"{counts['descent_steps']}; max |d - f64| {err:.3g}; {smi}", flush=True)
    _require(rows[20]["recall"] >= 0.95, lambda: f"1M NN-descent recall@10 {rows[20]['recall']} at efSearch=20")
    out = {"build_s": build_s, "peak_gib": peak, "phases": phases, "sweeps": sweeps, "repaired": repaired,
           "unreached": unreached, "search": rows}
    del idx, m, x_dev, q_dev
    torch.cuda.empty_cache()

    # side cells at 10,000 rows (cut from 20,000: the whole script took 1292.7 s of command on a
    # slow host, NVIDIA H100 80GB HBM3, 700 W), buildAlgo="nndescent" below the threshold
    n2 = 10_000
    side = dict(M=16, efConstruction=100, buildAlgo="nndescent")
    cu8 = np.rint(corpus[:n2]).astype(np.uint8)
    ang = clustered(n2 + 256, 100, seed=1)
    wide = sift_like(n2 + 256, 960, seed=3)
    cells = (  # label, space, index kwargs, space params, corpus, queries, build params, recall floor
        ("same seed (a)", "l2", {}, None, corpus[:n2], queries[:256], side, 0.9),
        ("same seed (b)", "l2", {}, None, corpus[:n2], queries[:256], side, 0.9),
        ("l2sqr_sift uint8", "l2sqr_sift", dict(data_type=DataKind.UINT8, dist_type=DistKind.INT), None, cu8,
         np.rint(queries[:256]).astype(np.uint8), side, 0.9),
        ("cosinesimil clustered", "cosinesimil", {}, Params(dim=100), ang[:n2], ang[n2:], side, 0.9),
        # three one-option variants in one build (each is held to tpu_knn on the CPU)
        ("nndRevMode=slots nndStoreDtype=float32 nndPolishStore=0", "l2", {}, None, corpus[:n2], queries[:256],
         dict(side, nndRevMode="slots", nndStoreDtype="float32", nndPolishStore=0), 0.85),
        ("D=960", "l2", {}, Params(dim=960), wide[:n2], wide[n2:], side, 0.9),
    )
    built = {}
    out["side"] = {}
    for label, name, kw, sparams, xs, qs, bp, floor in cells:
        ix = Index(name, sparams if sparams is not None else Params(dim=xs.shape[1]), device="cuda", **kw)
        (ix.add_uint8_batch if name == "l2sqr_sift" else ix.add_dense_batch)(xs)
        t0 = time.perf_counter()
        ix.build_index(Params(bp))
        torch.cuda.synchronize()
        bs = time.perf_counter() - t0
        chk = ix.method.check_graph()
        _, g_i = GoldStandard(ix.space, ix.store).compute_knn(qs, k)
        ix.set_query_time_params(Params(efSearch=50))
        rec = _recall_at(ix.knn_query_batch(qs, k)[1], g_i, k)
        wide_rows = xs.shape[1] * (1 if bp.get("nndStoreDtype", "int8") == "int8" else 4) >= TN.WIDE_ROW_BYTES
        print(f"[nnd] {label}, {n2} x {xs.shape[1]} {name}, {bp}: build {bs:.2f} s, check_graph {chk}, recall@{k} at "
              f"efSearch=50 {rec:.4f} (floor {floor}); wide-row branch {wide_rows}; {smi}", flush=True)
        _require(chk == zero and rec >= floor, lambda: f"nnd side cell {label}: check_graph {chk}, recall {rec}")
        out["side"][label] = {"build_s": bs, "recall": rec}
        if label.startswith("same seed"):
            built[label] = ix
        del ix
    a, b = built["same seed (a)"].method, built["same seed (b)"].method
    same = torch.equal(a.graph["level0"], b.graph["level0"]) and len(a._upper) > 0 and all(
        torch.equal(ua, ub) for ua, ub in zip(a._upper, b._upper))
    print(f"[nnd] same seed, {n2} rows: level 0 and {len(a._upper)} upper levels torch.equal {same}", flush=True)
    _require(same, lambda: "two NN-descent builds from one seed gave different graphs")
    del built, a, b
    torch.cuda.empty_cache()
    return out


# ---------------- phase 17: the other dense spaces ----------------

#: parameters of each space in phase 17 (lp at p=3, abdiv at 1.2/0.7, renyi at 0.75)
DENSE_PARAMS = {"lp": {"p": 3.0}, "abdiv_fast": {"alpha": 1.2, "beta": 0.7}, "abdiv_slow": {"alpha": 1.2, "beta": 0.7},
                "renyidiv_fast": {"alpha": 0.75}, "renyidiv_slow": {"alpha": 0.75}}
#: every name of the dense family beyond l2, the scalar products and l2sqr_sift
DENSE_NAMES = (
    "abdiv_fast", "abdiv_slow", "dummy", "itakurasaitofast", "itakurasaitofastrq", "itakurasaitoslow",
    "js_div_fast", "js_div_fast_approx", "js_div_slow", "jsdivfast", "jsdivfastapprox", "jsdivslow",
    "jsmetrfast", "jsmetrfastapprox", "jsmetrslow", "kldivfast", "kldivfastrq", "kldivgenfast",
    "kldivgenfastrq", "kldivgenslow", "l1", "linf", "lp", "renyidiv_fast", "renyidiv_slow",
)
#: the port's (and tpu_knn's) clamps and padding term
TINY, JS_TINY, PAD_TERM = 1e-30, 1e-38, 1e30


def _histograms(n: int, d: int, seed: int):
    """Dirichlet(0.1) rows normalised to the simplex in f32, from seeded
    numpy gamma samples: some components underflow to 0 and reach the
    spaces' 1e-30 clamp."""
    g = np.random.default_rng(seed).standard_gamma(0.1, size=(n, d), dtype=np.float32)
    return g / g.sum(axis=1, keepdims=True)


def _dense_f64(name: str, q, x, params=None):
    """(d, s) float64 [Q, C]: the distance of each query row to each corpus
    row, and a magnitude s such that (D + 8) * u * s bounds the error of
    the port's f32 evaluation (the sum of the absolute terms it adds; for
    Renyi, (1 + |log g|) / |a - 1|). Plain torch in float64 from the
    reference formulas with tpu_knn's clamps, independent of the port's
    code. The JS metric gives the JS divergence (compare squared).
    ``params``: the space's parameters, DENSE_PARAMS' by default."""
    import torch

    p = DENSE_PARAMS.get(name, {}) if params is None else params
    dim = q.shape[1]

    def lg(v):
        return torch.log(torch.clamp_min(v, TINY))

    if name in ("l1", "dummy", "linf", "lp"):
        t = (q[:, None, :] - x[None, :, :]).abs()
        if name == "linf":
            d = t.amax(-1)
            return d, d
        if name == "lp":
            d = (t ** p["p"]).sum(-1) ** (1.0 / p["p"])
            return d, d
        d = t.sum(-1)
        return d, d
    if name.startswith("js"):
        a, b = q[:, None, :], x[None, :, :]
        la, lb = torch.log(torch.clamp_min(a, JS_TINY)), torch.log(torch.clamp_min(b, JS_TINY))
        m = 0.5 * (a + b)
        lm = torch.log(torch.clamp_min(m, JS_TINY))
        ta = torch.where(a > 0, a * (la - lm), 0.0)
        tb = torch.where(b > 0, b * (lb - lm), 0.0)
        d = 0.5 * (ta + tb).sum(-1)
        s = 0.5 * (a * (la.abs() + lm.abs()) + b * (lb.abs() + lm.abs())).sum(-1)
        return d, s
    if name.startswith("renyi"):
        al = p["alpha"]
        g = torch.clamp_min(torch.clamp_min(q, TINY) ** al @ (torch.clamp_min(x, TINY) ** (1.0 - al)).T, 1e-30)
        return torch.log(g) / (al - 1.0), (1.0 + torch.log(g).abs()) / abs(al - 1.0)
    if name.startswith("abdiv"):
        al, be = p["alpha"], p["beta"]
        sm = al + be
        qa, xb = torch.clamp_min(q, TINY) ** al, torch.clamp_min(x, TINY) ** be
        qs = (torch.clamp_min(q, TINY) ** sm).sum(1)[:, None]
        xs = (torch.clamp_min(x, TINY) ** sm).sum(1)[None, :]
        d = -(qa @ xb.T - al / sm * qs - be / sm * xs) / (al * be)
        s = (qa.norm(dim=1)[:, None] * xb.norm(dim=1)[None, :] + al / sm * qs + be / sm * xs) / abs(al * be)
        return d, s
    rq = name.endswith("rq")
    if name.startswith("itakurasaito"):
        # IS(a, b) = sum a/b - log(a/b) - 1 with a = q (b = x), or reversed
        num, den = (x, q) if rq else (q, x)
        inv = 1.0 / torch.clamp_min(den, TINY)
        g = inv @ num.T if rq else num @ inv.T
        ln, ld = lg(num).sum(1), lg(den).sum(1)
        ln, ld = (ln[None, :], ld[:, None]) if rq else (ln[:, None], ld[None, :])
        d = g - ln + ld - dim
        nn, nd = num.norm(dim=1), inv.norm(dim=1)
        prod = (nd[:, None] * nn[None, :]) if rq else (nn[:, None] * nd[None, :])
        return d, prod + ln.abs() + ld.abs() + dim
    # KL(a || b) = sum a log a - a . log b (generalized: - sum a + sum b), a = q, or x when reversed
    gen = "gen" in name
    if rq:
        alog = (x * lg(x)).sum(1)[None, :]
        cross = lg(q) @ x.T
        sa, sb = x.sum(1)[None, :], q.sum(1)[:, None]
        prod = lg(q).norm(dim=1)[:, None] * x.norm(dim=1)[None, :]
    else:
        alog = (q * lg(q)).sum(1)[:, None]
        cross = q @ lg(x).T
        sa, sb = q.sum(1)[:, None], x.sum(1)[None, :]
        prod = q.norm(dim=1)[:, None] * lg(x).norm(dim=1)[None, :]
    d = alog - cross + ((sb - sa) if gen else 0.0)
    return d, prod + alog.abs() + ((sa.abs() + sb.abs()) if gen else 0.0)


def _dense_rows_per_chunk(name: str, nq: int, d: int) -> int:
    """Corpus rows per float64 oracle chunk: [Q, C, D] for the elementwise
    distances, [Q, C] for the products, about 2 GiB either way."""
    per_row = nq * (d if name in ("l1", "dummy", "linf", "lp") or name.startswith("js") else 1) * 8 * 6
    return max(256, (2 << 30) // per_row)


def _dense_oracle(name: str, q, x, k: int, params=None):
    """Float64 top-k (ascending; ties by lower position) of ``name`` over
    the corpus ``x``, chunk by chunk: (dists [Q, k], positions [Q, k])."""
    import torch

    q64 = q.double()
    step = _dense_rows_per_chunk(name, q.shape[0], q.shape[1])
    best_d = torch.empty((q.shape[0], 0), dtype=torch.float64, device=q.device)
    best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=q.device)
    for s in range(0, x.shape[0], step):
        d, _ = _dense_f64(name, q64, x[s:s + step].double(), params)
        allv = torch.cat([best_d, d], 1)
        alli = torch.cat([best_i, torch.arange(s, s + d.shape[1], device=q.device).expand(q.shape[0], -1)], 1)
        best_d, sel = torch.sort(allv, dim=1, stable=True)
        best_d, sel = best_d[:, :k], sel[:, :k]
        best_i = torch.gather(alli, 1, sel)
    return best_d, best_i


def _dense_pairs(name: str, q, x, pos, params=None):
    """(d, s) float64 [Q, k] of each query against its own rows x[pos]."""
    import torch

    q64 = q.double()
    d, s = [], []
    for r in range(q.shape[0]):  # [1, k] each: small
        dr, sr = _dense_f64(name, q64[r:r + 1], x[pos[r]].double(), params)
        d.append(dr[0])
        s.append(sr[0])
    return torch.stack(d), torch.stack(s)


def _check_dense_oracle(label, name, ids, dists, q, x, k: int, params=None):
    """The port's kNN result against the float64 oracle of ``name``: ids
    equal except on ties, a tie being two ids whose f64 distances lie
    within 2B, B = (D + 8) * u * s the bound on the f32 evaluation of
    either pair; every returned distance within B (+ 8u of itself) of its
    id's f64 distance. Oracle slots at or beyond tpu_knn's padding term
    (1e30) are skipped: a padded row scores there too. Returns the counts
    it printed."""
    import torch

    dev = q.device
    square = name.startswith("jsmetr")
    od, oi = _dense_oracle(name, q, x, k, params)
    ids_t = torch.as_tensor(ids.astype(np.int64), device=dev)
    valid = od < PAD_TERM
    _require(bool((ids_t[valid] >= 0).all()), lambda: f"{label}: an id of -1 where the oracle has a row")
    dret, sret = _dense_pairs(name, q, x, ids_t.clamp(min=0), params)
    _, sor = _dense_pairs(name, q, x, oi, params)
    bound = (q.shape[1] + 8) * U * torch.maximum(sret, sor)
    got = torch.as_tensor(dists, device=dev).double()
    if square:
        got = got * got
    diff = (ids_t != oi) & valid
    tie = (dret - od).abs() <= 2.0 * bound
    bad = diff & ~tie
    _require(not bool(bad.any()), lambda: (
        f"{label}: {int(bad.sum())} ids differ from the f64 oracle beyond ties; first query "
        f"{int(bad.any(1).nonzero()[0])}, worst gap/2B {float(((dret - od).abs() / (2 * bound))[bad].max()):.3g}"))
    err = (got - dret).abs()
    lim = bound + 8 * U * got.abs()
    _require(bool((err <= lim)[valid].all()), lambda: (
        f"{label}: a distance beyond the f32 bound of its id's f64 distance, worst ratio "
        f"{float((err / lim)[valid].max()):.3g}"))
    distinct = bool((ids_t.sort(dim=1).values.diff(dim=1) > 0)[valid[:, 1:]].all())
    _require(distinct, lambda: f"{label}: a repeated id in a row")
    worst = float(((dret - od).abs() / (2 * bound))[diff].max()) if bool(diff.any()) else 0.0
    print(f"[oracle] {label}: {q.shape[0]} queries x k={k}: ids equal to the f64 oracle at "
          f"{int((~diff & valid).sum())}/{int(valid.sum())} slots, the other {int(diff.sum())} ties within 2B "
          f"(worst gap/2B {worst:.3g}); max |d - f64| / B {float((err / lim)[valid].max()):.3g}"
          + (f"; {int((~valid).sum())} slots at or past the padding term" if bool((~valid).any()) else ""),
          flush=True)
    return int(diff.sum())


# ---- the elementwise kernel (csrc/groupmin_elementwise.cu) ----

#: phase 17's timed checks of the elementwise kernel at 65,536 rows: label -> (form, p, torch.cdist's
#: p; None: no library call computes JS). lp at p=3 runs a product chain, at p=0.7 the MUFU route.
EW_CHECK = {"l1": ("l1", None, 1.0), "linf": ("linf", None, float("inf")), "lp": ("lp", 3.0, 3.0),
            "lp p=0.7": ("lp", 0.7, 0.7), "js": ("js", None, None)}
#: FP32 instruction issue of an H100 SXM: 132 SMs x 128 lanes x 1.98 GHz. The 67 TFLOP/s peak
#: counts an FFMA as two operations; a subtraction, an addition or a max is one instruction.
FP32_INSTR_PER_S = PEAK_OPS["float32"] / 2
#: MUFU results (the special-function unit's lg2 and ex2) of an H100 SXM: 16 a clock an SM
#: (CUDA C++ Programming Guide, throughput of the arithmetic instructions, compute capability
#: 9.0), an eighth of the FP32 issue
MUFU_PER_S = FP32_INSTR_PER_S / 8
#: (FP32 instructions, MUFU operations) that an element pair of each form needs at least,
#: whatever the implementation: l1 a subtraction (abs is a free modifier) and an addition;
#: linf a subtraction and a NaN-carrying max; lp at a p that is no integer |a-b|^p =
#: ex2(p lg2|a-b|), two MUFU beside the subtraction, the product with p and the addition (at an
#: integer p a product chain and no MUFU: _ew_min_ops); JS one lg2 of m = (a+b)/2, since
#: 0.5(t(a) + t(b)) = 0.5(a log a + b log b) - m log m and the a log a and b log b sums are a
#: query's and a row's, beside m, its clamp and one FFMA into the sum
EW_MIN_OPS = {"l1": (2, 0), "linf": (2, 0), "lp": (3, 2), "js": (3, 1)}
EW_RTOL, EW_ATOL = 5e-3, 1e-5
EW_ROWS = 65_536
#: the lp powers of the edge sweep: the MUFU route (0.5, 0.7) and every product chain's instance
EW_SWEEP_P = (0.5, 0.7, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0)
#: each elementwise row of the kernels record -> (the launch count it reads, the run of phase 17
#: that count comes from: the 1M cells' pass 1, the 20,000-row two-pass and 3,000-row
#: single-pass runs; where its other numbers come from: a 1M cell's pass 1 or an EW_CHECK label)
EW_RECORD = {
    "elementwise_groupmin_l1": ("elementwise_groupmin_l1", "l1 1M", "l1 1M"),
    "elementwise_groupmin_linf": ("elementwise_groupmin_linf", "linf twopass", "linf"),
    "elementwise_groupmin_lp": ("elementwise_groupmin_lp", "lp twopass", "lp"),
    "elementwise_groupmin_lp_p0.7": ("elementwise_groupmin_lp", "lp p=0.7 twopass", "lp p=0.7"),
    "elementwise_groupmin_js": ("elementwise_groupmin_js", "jsdivfast 1M", "jsdivfast 1M"),
    "elementwise_dists_l1": ("elementwise_dists_l1", "l1 single", "l1"),
    "elementwise_dists_linf": ("elementwise_dists_linf", "linf single", "linf"),
    "elementwise_dists_lp": ("elementwise_dists_lp", "lp single", "lp"),
    "elementwise_dists_lp_p0.7": ("elementwise_dists_lp", "lp p=0.7 single", "lp p=0.7"),
    "elementwise_dists_js": ("elementwise_dists_js", "jsdivfast single", "js"),
    # the batched epilogue: pass 2 of the 1M cells, and the pair kernel at each pair shape of the
    # hnsw l1 cell's build, its launches there (the forward heuristic's 108 x 108, the reverse
    # shrink's 40 x 40 and 24 x 24; EW_BATCHED's 100 x 100, which the build does not launch, is
    # timed and printed but not recorded)
    "elementwise_batched_l1": ("elementwise_batched_l1", "l1 1M", "l1 pass 2"),
    "elementwise_batched_js": ("elementwise_batched_js", "jsdivfast 1M", "js pass 2"),
    "elementwise_batched_l1_pairs": ("elementwise_batched_l1", "hnsw l1 pairs 108x108", "l1 pairs 108"),
    "elementwise_batched_l1_pairs_40": ("elementwise_batched_l1", "hnsw l1 pairs 40x40", "l1 pairs 40"),
    "elementwise_batched_l1_pairs_24": ("elementwise_batched_l1", "hnsw l1 pairs 24x24", "l1 pairs 24"),
}
#: the hnsw l1 cell's pair shapes (Cq = K) that the record counts apart: the forward heuristic's
#: efConstruction + 8 candidates, the reverse shrink's 2M + 8 (level 0) and M + 8
EW_PAIR_SHAPES = (108, 40, 24)
#: the batched epilogue's timed checks: label -> (form, p, B, Cq, K, the rows (phase 4's "sift" or
#: the "hist"ograms), torch.cdist's p or None). "pass 2": a 1M cell's re-score, 1024 queries a
#: launch (seq_search._PASS2_QBLK) against the 1536 rows of their kg = 12 groups; "pairs": the
#: construction heuristic's pairs, C x C = 100 x 100 of a 1024-point wave, and the hnsw l1 cell's
#: own shapes (EW_PAIR_SHAPES): the forward heuristic's 108 x 108 at B = 1024, the reverse
#: shrink's 40 x 40 and 24 x 24 at B = 16384
EW_BATCHED = {
    "l1 pass 2": ("l1", None, 1024, 1, 1536, "sift", 1.0), "js pass 2": ("js", None, 1024, 1, 1536, "hist", None),
    "l1 pairs": ("l1", None, 1024, 100, 100, "sift", 1.0),
    "l1 pairs 108": ("l1", None, 1024, 108, 108, "sift", 1.0),
    "l1 pairs 40": ("l1", None, 16384, 40, 40, "sift", 1.0),
    "l1 pairs 24": ("l1", None, 16384, 24, 24, "sift", 1.0),
    "linf pairs 108": ("linf", None, 1024, 108, 108, "sift", float("inf")),
    "lp p=3 pairs 108": ("lp", 3.0, 1024, 108, 108, "sift", 3.0),
    "lp p=0.7 pairs 108": ("lp", 0.7, 1024, 108, 108, "sift", 0.7),
    "js pairs 108": ("js", None, 1024, 108, 108, "hist", None),
}
#: tpu_knn's JS of a pair with one 2e38 cell on each side, in both packages' plain versions
EW_JS_HUGE = 1.3863068e38
#: opcode prefixes of SASS that is no arithmetic: loads, stores, barriers, branches, moves from
#: special or constant registers
_SASS_NOT_ARITH = ("LD", "ST", "BAR", "BRA", "NOP", "EXIT", "DEPBAR", "BSSY", "BSYNC", "WARPSYNC", "MEMBAR",
                   "S2R", "CS2R", "ULDC")


def _sass_functions(lib_path) -> dict:
    """{mangled name: {"ins": [(address, opcode, text)], "labels": {label: address}}} of a
    library's SASS, from the toolkit's cuobjdump."""
    import os
    import shutil

    exe = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    exe = exe if os.path.exists(exe) else shutil.which("cuobjdump")
    _require(exe is not None, lambda: "cuobjdump not found: the elementwise kernel's bound needs its SASS")
    txt = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True, check=True,
                         timeout=300).stdout
    funcs, cur, pending = {}, None, []
    for ln in txt.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            cur, pending = funcs.setdefault(m.group(1), {"ins": [], "labels": {}}), []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if cur is not None and m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if cur is not None and m:
            addr, text = int(m.group(1), 16), m.group(2).strip()
            for lab in pending:
                cur["labels"][lab] = addr
            pending = []
            cur["ins"].append((addr, re.sub(r"^@!?U?P[T0-9]+\s+", "", text).split()[0], text))
    return funcs


def _branch_target(text: str, labels: dict):
    lab, hexa = re.search(r"`\((\.L_x_\d+)\)", text), re.search(r"0x([0-9a-f]+)", text)
    return labels.get(lab.group(1)) if lab else (int(hexa.group(1), 16) if hexa else None)


def _inner_loop_paths(fn) -> list:
    """[(loop, path)] of each of a function's innermost loops (a backward
    branch's range holding no other), largest first: every instruction of
    the loop body, and those on its fall-through path, the one a pass takes
    when no conditional branch is taken (unconditional forward branches
    followed): the main path of the special-value fix-ups and selects that
    ptxas puts behind branches."""
    ins = fn["ins"]
    loops = [(t, a) for a, op, text in ins if op.startswith("BRA")
             for t in [_branch_target(text, fn["labels"])] if t is not None and t <= a]
    inner = [(a, b) for a, b in loops if not any(a <= c and e <= b and (c, e) != (a, b) for c, e in loops)]
    _require(bool(inner), lambda: "no loop in the SASS of an elementwise kernel")
    out = []
    for head, tail in sorted(inner, key=lambda ab: ab[0] - ab[1]):
        loop = [t for t in ins if head <= t[0] <= tail]
        at = {t[0]: i for i, t in enumerate(loop)}
        path, i = [], 0
        while True:
            addr, op, text = loop[i]
            path.append(loop[i])
            if addr == tail:
                break
            tgt = _branch_target(text, fn["labels"]) if op.startswith("BRA") and not text.startswith("@") else None
            _require(tgt is None or (tgt > addr and tgt in at),
                     lambda: f"elementwise SASS: branch {text} at {addr:#x}")
            i = at[tgt] if tgt is not None else i + 1
        out.append((loop, path))
    return out


def _ew_sass(lib_path) -> dict:
    """{"instance epilogue": counts} of each instance of the elementwise kernel (named as
    ops/elementwise.py's ``instance`` names them: l1, linf, lp (the MUFU route), lp3..lp8 (the
    product chains), js): the instructions of its loop over the element pairs, and the
    arithmetic ones on the loop's fall-through path, per element pair of one pass of that loop
    (ku k steps of a tq x tr register tile). JS has two such loops: the one for tiles of
    non-negative values is counted, the guarded one (a negative or NaN value in the tile) is
    given as ``guarded_per_pair``. The arithmetic count gives the issue efficiency."""
    from tpu_knn_torch.ops import elementwise as EW

    out = {}
    for name, fn in _sass_functions(lib_path).items():
        m = re.search(r"groupmin_elementwise_kernelILi(\d)ELi(\d+)ELb(\d)E", name)
        if not m:
            continue
        form, power = EW.KERNEL_FORMS[int(m.group(1))], int(m.group(2))
        p = float(power) if power else None
        g = EW.geometry(form, p)
        pairs = g["ku"] * g["tq"] * g["tr"]
        loops = []  # (arithmetic on the path, loop, path, its opcodes) of each loop over the pairs
        for loop, path in _inner_loop_paths(fn):
            arith = [op for _, op, _ in path if not op.startswith(_SASS_NOT_ARITH)]
            if len(arith) >= pairs:
                loops.append((len(arith), loop, path, arith))
        want = 2 if form == "js" else 1
        _require(len(loops) == want, lambda: f"elementwise SASS {name}: {len(loops)} loops over the pairs, want {want}")
        loops.sort(key=lambda t: t[0])
        n_arith, loop, path, arith = loops[0]
        ops = {}
        for op in arith:
            ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
        key = f"{EW.instance(form, p)} {'groupmin' if m.group(3) == '1' else 'dists'}"
        out[key] = {"arith_per_pair": n_arith / pairs, "path_per_pair": len(path) / pairs, "loop": len(loop),
                    "pairs": pairs, "geometry": g, "opcodes": ops}
        if len(loops) > 1:
            out[key]["guarded_per_pair"] = loops[1][0] / pairs
    powers = (None,) + tuple(float(v) for v in EW.LP_POWERS)
    want_keys = {f"{EW.instance(f, p)} {e}" for f in EW.KERNEL_FORMS for p in (powers if f == "lp" else (None,))
                 for e in ("groupmin", "dists")}
    _require(set(out) == want_keys, lambda: f"elementwise SASS: instances {sorted(out)}, want {sorted(want_keys)}")
    return out


def _chain_len(p: int) -> int:
    """The fewest multiplications that make t^p from t: the length of p's shortest addition
    chain, by iterative deepening (p=3 and 4: 2; 5, 6 and 8: 3; 7: 4)."""

    def reach(chain, depth):
        top = chain[-1]
        left = depth - (len(chain) - 1)
        if top == p:
            return True
        if left == 0 or top << left < p:
            return False
        sums = {a + b for a in chain for b in chain if top < a + b <= p}
        return any(reach(chain + [v], depth) for v in sorted(sums, reverse=True))

    depth = 0
    while not reach([1], depth):
        depth += 1
    return depth


def _ew_min_ops(form: str, p=None) -> tuple:
    """(FP32 instructions, MUFU operations) that an element pair of ``form`` needs at least
    (``EW_MIN_OPS``); lp at an integer p a product chain: the subtraction and p's shortest
    chain of multiplications, the last one fused into the addition, no MUFU (p=3: (3, 0))."""
    if form == "lp" and p is not None and float(p).is_integer() and p >= 1:
        return 1 + max(_chain_len(int(p)), 1), 0
    return EW_MIN_OPS[form]


def _ew_least_ms(form: str, nbytes: int, pairs: int, p=None):
    """(least ms, "bytes" or "operations") of ``nbytes`` moved over the HBM rate against
    ``pairs`` element pairs of the form's least operations at ``p`` (``_ew_min_ops``): every
    instruction an issue slot at the FP32 issue rate, the MUFU operations at their own rate,
    whichever takes longer."""
    fp32, mufu = _ew_min_ops(form, p)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = pairs * max((fp32 + mufu) / FP32_INSTR_PER_S, mufu / MUFU_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def _ew_bound_ms(form: str, qn: int, n: int, d: int, epilogue: str, p=None):
    """(least ms, "bytes" or "operations") of one group-min or distance launch: q, x and pad read
    once and the mins (or distances) written once, against Q x N x D element pairs."""
    nbytes = 4 * (qn * d + n * d + n) + 4 * qn * (n // 128 if epilogue == "groupmin" else n)
    return _ew_least_ms(form, nbytes, qn * n * d, p)


def _ew_batched_bound_ms(form: str, nb: int, cq: int, k: int, d: int, p=None):
    """(least ms, "bytes" or "operations") of one batched launch: q [B, Cq, D], rows [B, K, D] and
    pad [B, K] read once and the distances [B, Cq, K] written once, against B x Cq x K x D
    element pairs (pass 2, Cq = 1: bytes; the heuristic's pairs: operations)."""
    return _ew_least_ms(form, 4 * (nb * cq * d + nb * k * d + nb * k + nb * cq * k), nb * cq * k * d, p)


def _ew_measure(smi, label, form, epi, q, x, pad, p, cdist_p, sass, err, lib_reps) -> dict:
    """Kernel, plain and torch.cdist's ms (CUDA events) of one epilogue of ``form`` on these
    tensors, beside its bound and the SASS's issue efficiency: the kernel's own arithmetic
    instructions an element pair at the FP32 issue rate over its time. Prints and returns
    the numbers."""
    import torch
    from tpu_knn_torch.ops import elementwise as EW

    kern, plain = ((EW.elementwise_groupmin, EW.elementwise_groupmin_reference) if epi == "groupmin"
                   else (EW.elementwise_dists, EW.elementwise_dists_reference))
    (qn, d), n = q.shape, x.shape[0]
    lib_ms = _cuda_ms(lambda: torch.cdist(q, x, p=cdist_p), lib_reps) if cdist_p is not None else None
    kms = _cuda_ms(lambda: kern(form, q, x, pad, p), 5)
    pms = _cuda_ms(lambda: plain(form, q, x, pad, p), 1)
    inst = EW.instance(form, p)
    per_pair = sass[f"{inst} {epi}"]["arith_per_pair"]
    issue_ms = 1e3 * per_pair * qn * n * d / FP32_INSTR_PER_S
    bms, by = _ew_bound_ms(form, qn, n, d, epi, p)
    fp32, mufu = _ew_min_ops(form, p)
    print(f"[dense] kernel {label} {form}{'' if p is None else f' p={p}'} (instance {inst}) {epi} Q={qn} N={n} "
          f"D={d}: max |kernel - plain| {err:.4g} "
          + ("(bit-equal)" if form == "linf" else f"(within rtol {EW_RTOL})")
          + f"; kernel {kms:.3f} ms, plain {pms:.3f} ms, "
          + (f"torch.cdist(p={cdist_p}) {lib_ms:.3f} ms" if lib_ms is not None else "no library call")
          + f"; bound {bms:.3f} ms ({by}: {fp32} FP32 instructions and {mufu} MUFU operations an element pair "
          f"at {FP32_INSTR_PER_S / 1e12:.1f} T and {MUFU_PER_S / 1e12:.2f} T/s), {bms / kms:.1%} of it; issue "
          f"efficiency {issue_ms / kms:.1%} ({per_pair:.3f} of the SASS's arithmetic instructions an element pair "
          f"take {issue_ms:.3f} ms at the FP32 issue rate); {smi}", flush=True)
    return {"max_abs_err": err, "ms": kms, "plain_ms": pms, "library_ms": lib_ms, "bound_ms": bms,
            "bound_by": by, "arith_per_pair": per_pair, "issue_ms": issue_ms, "shape": [qn, n, d]}


def _ew_compare(label, got, ref, exact: bool, js=None) -> float:
    """The kernel's output against its plain version's: NaN cell for NaN cell, each infinity
    equal, finite cells bit-equal (``exact``) or within rtol 5e-3 / atol 1e-5. ``js``: the
    unpadded (q, rows, pad) of a batched jsmetr launch, whose finite cells beyond that tolerance
    are then held to float64 instead (_jsmetr_f64_ok): near 0 the sqrt turns the f32 rounding of a
    JS sum of order-1 terms into differences of 1e-4 to 1e-3 in either evaluation, the plain
    version's too. Returns the max |difference| over the finite cells."""
    import torch

    _require(got.shape == ref.shape, lambda: f"{label}: shape {tuple(got.shape)}, plain {tuple(ref.shape)}")
    nan_ok = torch.equal(torch.isnan(got), torch.isnan(ref))
    inf_ok = torch.equal(torch.isinf(got), torch.isinf(ref)) and torch.equal(got[torch.isinf(got)],
                                                                            ref[torch.isinf(ref)])
    fin = torch.isfinite(got) & torch.isfinite(ref)
    diff = torch.where(fin, got - ref, 0.0).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    off = fin & (diff > EW_RTOL * ref.abs() + EW_ATOL)
    if exact:
        close = bool((diff == 0).all())
    elif js is not None and bool(off.any()):
        close, worst = _jsmetr_f64_ok(got, off, *js)
        print(f"[dense] {label}: {int(off.sum())} cells beyond rtol {EW_RTOL} of the plain version; held to "
              f"float64: {close} (max |kernel^2 - JS f64| / the f32 bound {worst['ratio']:.3g}, max |kernel - f64| "
              f"{worst['kernel']:.4g}, max |plain - f64| {float((ref[off].double() - worst['f64']).abs().max()):.4g})",
              flush=True)
    else:
        close = not bool(off.any())
    _require(nan_ok and inf_ok and close, lambda: (
        f"{label}: kernel against its plain version: NaN cells equal {nan_ok}, infinities equal {inf_ok}, "
        f"finite cells {'bit-equal' if exact else 'within rtol 5e-3'} {close}, max |diff| {err:.4g}"))
    return err


def _js_f64(a, b):
    """(tpu_knn's JS (tpu_knn/ops/distance.py js_div_blocked) of each row pair of a [n, D] and b
    [n, D] in float64; a bound on the error of the kernel's f32 evaluation of it). The formula:
    0.5 sum [a (log a - log m) + b (log b - log m)], m = (a + b) / 2, a term 0 where its value
    is not > 0, logs of max(., 1e-38). The kernel sums, in quarter log2 units, a diff_a + b diff_b
    with diff_a = La/4 - L/4, La = lg2(2 max(a, 1e-38)), L = lg2(max(a + b, 2e-38)) on the MUFU
    (error at most 2^-22 (1 + |lg2|)), then scales by 2 ln 2. So diff_a is off by at most u (2.62
    + 1.25 |La| + |L| + |diff_a|) (the two lg2, the rounded a + b, the +1 of the huge branch, the
    FFMA), each product and sum rounds once (4 (D + 8) u times the sum of |a diff_a| + |b diff_b|
    over all of them), and the scaling twice (2 u |JS|)."""
    import torch

    lm = torch.log2(2.0 * torch.clamp_min(0.5 * (a + b), 1e-38))
    bound, terms, js = 0.0, 0.0, 0.0
    for v in (a, b):
        lv = torch.log2(2.0 * torch.clamp_min(v, 1e-38))
        dv = 0.25 * (lv - lm)
        live = v > 0
        t = torch.where(live, v * dv, 0.0)
        js = js + t.sum(-1)
        terms = terms + t.abs().sum(-1)
        bound = bound + torch.where(live, v * (2.62 + 1.25 * lv.abs() + lm.abs() + dv.abs()), 0.0).sum(-1)
    post = 2.0 * np.log(2.0)
    js = post * js
    return js, post * U * (bound + 4 * (a.shape[-1] + 8) * terms) + 2 * U * js.abs()


def _jsmetr_f64_ok(got, cells, q, rows, pad):
    """(whether every cell of the mask ``cells`` of a batched jsmetr output ``got`` [B, Cq, K] has
    pad 0 and a square, the kernel's JS, within _js_f64's bound of the float64 JS of its query
    q[b, i] and row rows[b, j] (and 3 u of the square, for the sqrt's rounding); the worst cell's
    numbers: "ratio" |got^2 - JS| over that limit, "kernel" |got - sqrt(JS)|, and "f64"
    sqrt(JS) of every cell of the mask)."""
    import torch

    b, i, j = cells.nonzero(as_tuple=True)
    js, bound = _js_f64(q[b, i].double(), rows[b, j].double())
    s = got[b, i, j].double()
    lim = bound + 3 * U * s * s
    ratio = (s * s - js).abs() / lim
    f64 = torch.sqrt(torch.clamp_min(js, 0.0))
    ok = bool(((pad[b, j] == 0) & (ratio <= 1.0)).all())
    return ok, {"ratio": float(ratio.max()), "kernel": float((s - f64).abs().max()), "f64": f64}


def _ew_edge_sweep() -> tuple:
    """Each form (lp at every p of EW_SWEEP_P, JS with and without its sqrt post) and both
    epilogues against the plain versions at small shapes: Q 1, 7, 130 (ragged), N 128 and 384
    (100 and 356 for the distance epilogue), D 8, 20 (zero columns appended), 24, 136, over
    histograms and over signed normals, with a zero row, a NaN cell, a +inf and a -inf cell in
    the corpus and a +inf cell and a zero row in the queries, and 1e30 pads. Then JS's self
    pairs at each D: the first 64 histogram rows (and their special cells) as queries, the
    kernel's js and jsmetr distances exactly 0.0 wherever the plain version's are. Returns
    (runs, the self-pair cells that are 0)."""
    import torch
    from tpu_knn_torch.ops import elementwise as EW

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    forms = (("l1", None), ("linf", None), *(("lp", p) for p in EW_SWEEP_P), ("js", None), ("jsmetr", None))
    runs = zeros = 0
    for d in (8, 20, 24, 136):
        for n in (128, 384):
            for qn in (1, 7, 130):
                for kind in ("hist", "normal"):
                    a = (rng.dirichlet(np.full(d, 0.1), n + qn) if kind == "hist"
                         else rng.standard_normal((n + qn, d)) * 4).astype(np.float32)
                    x, q = a[:n].copy(), a[n:].copy()
                    x[3], x[5, 1], x[6, 2], x[7, 0] = 0.0, np.nan, np.inf, -np.inf
                    if qn > 2:
                        q[1, 0], q[2] = np.inf, 0.0
                    pad = np.zeros(n, np.float32)
                    pad[-5:] = PAD_TERM
                    qt, xt, pt = (torch.from_numpy(v).to(dev) for v in (q, x, pad))
                    # the kernel takes D a multiple of 8: zero columns, as the spaces append them
                    zq, zx = (torch.nn.functional.pad(t, (0, -d % EW.D_MULTIPLE)) for t in (qt, xt))
                    for form, p in forms:
                        exact = form == "linf"
                        got = EW.elementwise_groupmin(form, zq, zx, pt, p)
                        _ew_compare(f"edge {form} p={p} groupmin Q={qn} N={n} D={d} {kind}", got,
                                    EW.elementwise_groupmin_reference(form, qt, xt, pt, p), exact)
                        nd = n - 28
                        got = EW.elementwise_dists(form, zq, zx[:nd], pt[:nd], p)
                        _ew_compare(f"edge {form} p={p} dists Q={qn} N={nd} D={d} {kind}", got,
                                    EW.elementwise_dists_reference(form, qt, xt[:nd], pt[:nd], p), exact)
                        runs += 2
                    if kind == "hist" and n == 384 and qn == 130:
                        for form in ("js", "jsmetr"):
                            got = EW.elementwise_dists(form, zx[:64].contiguous(), zx, pt)
                            ref = EW.elementwise_dists_reference(form, xt[:64], xt, pt)
                            _ew_compare(f"edge {form} self pairs D={d}", got, ref, False)
                            zero = ref == 0
                            # every diagonal cell but the +inf row's (NaN) is 0 in the plain version
                            _require(bool((got[zero] == 0).all()) and int(zero.diagonal().sum()) == 63,
                                     lambda: f"edge {form} self pairs D={d}: {int((got[zero] != 0).sum())} of "
                                             f"{int(zero.sum())} plain zeros not 0.0 in the kernel, "
                                             f"max {float(got[zero].abs().max()):.3g}; diagonal zeros "
                                             f"{int(zero.diagonal().sum())}")
                            zeros += int(zero.sum())
                            runs += 1
    torch.cuda.synchronize()
    return runs, zeros


def _ew_kernel_check(smi, x_sift, q_sift, x_hist, q_hist, sass: dict) -> dict:
    """Both epilogues of the elementwise kernel in each check of EW_CHECK against their plain
    versions on the first 65,536 rows (1e30 pads on the last 128) and every query: phase 4's
    rows for L1, LINF and LP (p=3 and 0.7), the histograms for JS (and its sqrt post); kernel,
    plain and torch.cdist's ms beside the bound. Returns {label: {epilogue: numbers}}."""
    import torch
    from tpu_knn_torch.ops import elementwise as EW

    out = {}
    for label, (form, p, cdist_p) in EW_CHECK.items():
        xs, q = (x_hist, q_hist) if form == "js" else (x_sift, q_sift)
        x = xs[:EW_ROWS].contiguous()
        pad = torch.zeros(EW_ROWS, dtype=torch.float32, device=x.device)
        pad[-128:] = PAD_TERM
        out[label] = {}
        for epi, kern, plain in (("groupmin", EW.elementwise_groupmin, EW.elementwise_groupmin_reference),
                                 ("dists", EW.elementwise_dists, EW.elementwise_dists_reference)):
            err = 0.0
            for f in (("js", "jsmetr") if form == "js" else (form,)):
                got = kern(f, q, x, pad, p)
                torch.cuda.synchronize()
                err = max(err, _ew_compare(f"{f} p={p} {epi} Q={q.shape[0]} N={EW_ROWS}", got,
                                           plain(f, q, x, pad, p), exact=form == "linf"))
                del got
            out[label][epi] = _ew_measure(smi, f"{EW_ROWS}-row slice", form, epi, q, x, pad, p, cdist_p, sass,
                                          err, 3)
    return out


def _ew_index_inputs(idx, queries):
    """(form, p, q, x, pad): the elementwise form of ``idx``'s space and the tensors its scan
    hands the kernel: the encoded queries, the padded store and its pads."""
    space, data = idx.space, idx.method.data
    form, p = space.pass1_elementwise()
    qpts, _ = idx._bucket_query_points(queries)
    return form, p, space.encode_queries(qpts)["q"], data.vecs, data.extra["pad"]


def _ew_hold_index(label, idx, queries, route: str) -> float:
    """The elementwise kernel against its plain version on the tensors ``idx``'s scan hands it:
    pass 1's group mins over the whole store (``route`` "twopass"), or each chunk's distances
    (the single pass and range). Returns the max |difference|."""
    from tpu_knn_torch.ops import elementwise as EW

    form, p, q, x, pad = _ew_index_inputs(idx, queries)
    exact = form == "linf"
    if route == "twopass":
        return _ew_compare(f"{label} groupmin", EW.elementwise_groupmin(form, q, x, pad, p),
                           EW.elementwise_groupmin_reference(form, q, x, pad, p), exact)
    chunk, err = idx.method._chunk, 0.0
    for s in range(0, x.shape[0], chunk):
        xc, pc = x[s:s + chunk], pad[s:s + chunk]
        err = max(err, _ew_compare(f"{label} dists rows {s}:{s + chunk}", EW.elementwise_dists(form, q, xc, pc, p),
                                   EW.elementwise_dists_reference(form, q, xc, pc, p), exact))
    return err


def _ew_main_check(smi, label, idx, queries, cdist_p, sass) -> dict:
    """The group-min epilogue at the shapes a 1M cell's pass 1 gives it (the index's own store,
    pads and encoded queries) against its plain version on the same tensors, then timed beside
    its bound and torch.cdist (one run: it writes every distance)."""
    from tpu_knn_torch.ops import elementwise as EW

    form, p, q, x, pad = _ew_index_inputs(idx, queries)
    err = _ew_compare(f"{label} groupmin", EW.elementwise_groupmin(form, q, x, pad, p),
                      EW.elementwise_groupmin_reference(form, q, x, pad, p), exact=form == "linf")
    return _ew_measure(smi, label, EW.kernel_form(form), "groupmin", q, x, pad, p, cdist_p, sass, err, 1)


class _PlainGuard:
    """Counts, while active, the calls on CUDA tensors of a kernel's plain arithmetic: by default
    the elementwise kernel's (ops/elementwise.distances, which every plain version runs, and the
    ops/distance blocks it takes): on the card every scorer of the thirteen elementwise names
    launches the kernel, so an index run must count 0. ``SPARSE_PLAIN`` names the sparse scan's
    (ops/sparse.qdense_dists_reference and the two products it runs). Calls made while
    :meth:`paused` (a kernel held against its plain version) do not count."""

    _paused = 0

    def __init__(self, targets=None):
        self.targets = targets or (("elementwise", "distances"), ("distance", "l1_blocked"),
                                   ("distance", "linf_blocked"), ("distance", "lp_blocked"),
                                   ("distance", "js_div_blocked"))

    def __enter__(self):
        import importlib

        import torch

        self.count, self._saved = 0, []
        for mod_name, fn in self.targets:
            mod = importlib.import_module(f"tpu_knn_torch.ops.{mod_name}")
            real = getattr(mod, fn)

            def spy(*args, _real=real, **kw):
                # a tensor or the sparse scan's postings on the card
                if not _PlainGuard._paused and any(getattr(getattr(a, "device", None), "type", None) == "cuda"
                                                   for a in args):
                    self.count += 1
                return _real(*args, **kw)

            setattr(mod, fn, spy)
            self._saved.append((mod, fn, real))
        return self

    def __exit__(self, *exc):
        for mod, fn, real in self._saved:
            setattr(mod, fn, real)

    @staticmethod
    @contextlib.contextmanager
    def paused():
        _PlainGuard._paused += 1
        try:
            yield
        finally:
            _PlainGuard._paused -= 1


#: the sparse scan's plain arithmetic (ops/sparse.py), which no run of phases 18-20 calls on the card
SPARSE_PLAIN = (("sparse", "qdense_dists_reference"), ("sparse", "postings_table"), ("sparse", "dot_qdense"),
                ("sparse", "intersect_count_qdense"))


#: the batched sweep's (Cq, K): Cq 1, 5 and 40 against K 1, 37 and 300
EW_SWEEP_CK = tuple((cq, k) for k in (1, 37, 300) for cq in (1, 5, 40))
#: and the pair kernel's: Cq = K of the build's reverse shrink (24) and forward heuristic (108), a
#: prime split over blocks unevenly (129), efConstruction 200's (208), and Cq > K over several
#: blocks (136 x 72). Only here may a jsmetr cell beyond rtol 5e-3 of the plain version be held to
#: float64 (_ew_compare's js): at 1e5 cells a shape, some tiny-kind cells at D = 8 sum to a JS
#: near 0 whose sqrt neither f32 evaluation gets to 5e-3
EW_SWEEP_PAIRS = ((24, 24), (108, 108), (129, 129), (208, 208), (136, 72))


class _BatchedShapes:
    """Counts, while active, the calls of ops/elementwise.elementwise_batched on non-empty CUDA
    tensors by (Cq, K), each one launch of the gathered (Cq = 1) or the pair kernel."""

    def __enter__(self):
        import collections

        from tpu_knn_torch.ops import elementwise as EW

        self.counts, self._real = collections.Counter(), EW.elementwise_batched

        def spy(form, q, rows, pad, p=None):
            if q.is_cuda and q.numel() and rows.numel():  # as _launch counts its launches
                self.counts[(int(q.shape[1]), int(rows.shape[1]))] += 1
            return self._real(form, q, rows, pad, p)

        EW.elementwise_batched = spy
        return self

    def __exit__(self, *exc):
        from tpu_knn_torch.ops import elementwise as EW

        EW.elementwise_batched = self._real


def _ew_batched_sweep() -> int:
    """The batched epilogue against its plain version at small shapes: each form (lp at every p
    of EW_SWEEP_P, JS with and without its sqrt post) at B = 3 and each (Cq, K) of EW_SWEEP_CK and
    EW_SWEEP_PAIRS (the gathered kernel at Cq = 1, the pair kernel's tilings above it: items side
    by side, tiles over blocks, ragged tiles), D 8, 20 (zero columns appended) and 136, over histograms, signed normals
    and tiny cells (values in [1e-39, 4e-38) among zeros and signed normals), with a zero row, a
    NaN, a +inf and a -inf cell in the rows, a +inf cell and a zero row in the queries, and +inf
    and 1e30 pads. Returns the runs."""
    import torch
    from tpu_knn_torch.ops import elementwise as EW

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(16)
    forms = (("l1", None), ("linf", None), *(("lp", p) for p in EW_SWEEP_P), ("js", None), ("jsmetr", None))
    nb, runs = 3, 0
    for d in (8, 20, 136):
        for cq, k in EW_SWEEP_CK + EW_SWEEP_PAIRS:
            for kind in ("hist", "normal", "tiny"):
                n = nb * (cq + k)
                if kind == "hist":
                    a = rng.dirichlet(np.full(d, 0.1), n)
                else:
                    a = rng.standard_normal((n, d)) * 4
                    if kind == "tiny":
                        r = rng.random((n, d))
                        a = np.where(r < 0.4, rng.uniform(1e-39, 4e-38, (n, d)), np.where(r < 0.6, 0.0, a))
                a = a.astype(np.float32)
                q, rows = a[:nb * cq].reshape(nb, cq, d).copy(), a[nb * cq:].reshape(nb, k, d).copy()
                rows[0, 0] = 0.0
                rows[1, -1, 0], rows[2, -1, 1 % d] = np.nan, np.inf
                rows[2, 0, 0] = -np.inf
                q[1, -1, 0] = np.inf
                q[2, 0] = 0.0
                pad = np.zeros((nb, k), np.float32)
                pad[0, -1], pad[1, 0] = np.inf, PAD_TERM
                qt, rt, pt = (torch.from_numpy(v).to(dev) for v in (q, rows, pad))
                zq, zr = (torch.nn.functional.pad(t, (0, -d % EW.D_MULTIPLE)).contiguous() for t in (qt, rt))
                for form, p in forms:
                    got = EW.elementwise_batched(form, zq, zr, pt, p)
                    js = (qt, rt, pt) if form == "jsmetr" and (cq, k) in EW_SWEEP_PAIRS else None
                    _ew_compare(f"edge batched {form} p={p} B={nb} Cq={cq} K={k} D={d} {kind}", got,
                                EW.elementwise_batched_reference(form, qt, rt, pt, p), form == "linf", js)
                    runs += 1
    torch.cuda.synchronize()
    return runs


def _ew_js_huge() -> dict:
    """The JS pair of two 2e38 cells, one on each side (q [2e38, 0, ...] against rows [0, 2e38,
    ...]), in the group-min, distance and batched epilogues (the gathered kernel at Cq = 1, the
    pair kernel at Cq = 2): EW_JS_HUGE (its sqrt for jsmetr)
    within rtol 5e-3, finite, and as the plain version gives it. In whole log2 units the sum was
    2e38 + 2e38 = +inf. Returns {"form epilogue": the kernel's value}."""
    import torch
    from tpu_knn_torch.ops import elementwise as EW

    dev = torch.device("cuda", 0)
    q = torch.zeros(1, 16, device=dev)
    x = torch.zeros(128, 16, device=dev)
    q[0, 0], x[:, 1] = 2e38, 2e38
    q2 = q.expand(2, 16).contiguous()
    pad = torch.zeros(128, device=dev)
    out = {}
    for form in ("js", "jsmetr"):
        want = EW_JS_HUGE if form == "js" else float(np.sqrt(EW_JS_HUGE))
        for epi, got, ref in (
                ("groupmin", EW.elementwise_groupmin(form, q, x, pad), EW.elementwise_groupmin_reference(form, q, x, pad)),
                ("dists", EW.elementwise_dists(form, q, x, pad), EW.elementwise_dists_reference(form, q, x, pad)),
                ("batched", EW.elementwise_batched(form, q[None], x[None], pad[None]),
                 EW.elementwise_batched_reference(form, q[None], x[None], pad[None])),
                ("pairs", EW.elementwise_batched(form, q2[None], x[None], pad[None]),
                 EW.elementwise_batched_reference(form, q2[None], x[None], pad[None]))):
            _ew_compare(f"JS huge pair {form} {epi}", got, ref, False)
            v = got.double().cpu().numpy()
            _require(np.isfinite(v).all() and np.allclose(v, want, rtol=EW_RTOL, atol=0),
                     lambda: f"JS huge pair {form} {epi}: {v.ravel()[:4]}, want {want:.7g}")
            out[f"{form} {epi}"] = float(v.ravel()[0])
    return out


def _ew_batched_check(smi, x_sift, q_sift, x_hist, q_hist) -> dict:
    """The batched epilogue at EW_BATCHED's shapes against its plain version (and, for JS, its
    sqrt post too): the first B queries (pass 2) or rows drawn from seed 16 (pairs) as queries,
    each batch item's rows its own whole 128-row groups (pass 2, as _pass2 gathers them) or rows
    drawn from the seed, the last 64 of the last item +inf-padded; kernel, plain and batched
    torch.cdist ms (CUDA events) beside the bound and the tiling (batched_geometry). Returns
    {label: numbers}."""
    import torch
    from tpu_knn_torch.ops import elementwise as EW

    dev = x_sift.device
    gen = torch.Generator(device=dev).manual_seed(16)
    out = {}
    for label, (form, p, nb, cq, k, src, cdist_p) in EW_BATCHED.items():
        xs, qs = (x_hist, q_hist) if src == "hist" else (x_sift, q_sift)
        d = xs.shape[1]
        if cq == 1:
            groups = torch.randint(0, xs.shape[0] // 128, (nb, k // 128), device=dev, generator=gen)
            ids = (groups[:, :, None] * 128 + torch.arange(128, device=dev)).reshape(nb, k)
            q = qs[:nb, None, :].contiguous()
        else:
            ids = torch.randint(0, xs.shape[0], (nb, k), device=dev, generator=gen)
            q = xs[torch.randint(0, xs.shape[0], (nb, cq), device=dev, generator=gen)]
        rows = xs[ids]
        pad = torch.zeros(nb, k, device=dev)
        pad[-1, -64:] = float("inf")
        err = 0.0
        for f in (("js", "jsmetr") if form == "js" else (form,)):
            got = EW.elementwise_batched(f, q, rows, pad, p)
            torch.cuda.synchronize()
            err = max(err, _ew_compare(f"batched {label} {f}", got,
                                       EW.elementwise_batched_reference(f, q, rows, pad, p), f == "linf"))
            del got
        kms = _cuda_ms(lambda: EW.elementwise_batched(form, q, rows, pad, p), 10)
        pms = _cuda_ms(lambda: EW.elementwise_batched_reference(form, q, rows, pad, p), 1)
        lib_ms = _cuda_ms(lambda: torch.cdist(q, rows, p=cdist_p), 3) if cdist_p is not None else None
        bms, by = _ew_batched_bound_ms(form, nb, cq, k, d, p)
        fp32, mufu = _ew_min_ops(form, p)
        geo = EW.batched_geometry(cq, k, form)
        print(f"[dense] kernel batched {label} {form}{'' if p is None else f' p={p}'} B={nb} Cq={cq} K={k} D={d} "
              f"(geometry {json.dumps(geo)}): max |kernel - plain| {err:.4g} "
              + ("(bit-equal)" if form == "linf" else f"(within rtol {EW_RTOL})")
              + f"; kernel {kms:.3f} ms, plain {pms:.3f} ms, "
              + (f"batched torch.cdist(p={cdist_p}) {lib_ms:.3f} ms" if lib_ms is not None else "no library call")
              + f"; bound {bms:.3f} ms ({by}: {4 * (nb * cq * d + nb * k * d + nb * k + nb * cq * k) / 1e9:.3f} GB at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, {fp32} FP32 instructions and {mufu} MUFU operations an element "
              f"pair), {bms / kms:.1%} of it; {smi}", flush=True)
        out[label] = {"max_abs_err": err, "ms": kms, "plain_ms": pms, "library_ms": lib_ms, "bound_ms": bms,
                      "bound_by": by, "shape": [nb, cq, k, d], "geometry": geo}
        del q, rows, pad, ids
        torch.cuda.empty_cache()
    return out


def _phase_dense(smi, corpus, queries):
    """Phase 17: the dense spaces beyond l2, the scalar products and
    l2sqr_sift, over Dirichlet(0.1) histograms (the LDA topic histograms
    of NMSLIB's KL and JS deployments, which the repository does not hold)
    and phase 4's sift_like rows for l1. Returns the numbers it printed."""
    import torch
    from tpu_knn_torch import Index, Params
    from tpu_knn_torch.eval import GoldStandard
    from tpu_knn_torch.methods import seq_search as SS
    from tpu_knn_torch.ops import elementwise as EW
    from tpu_knn_torch.ops import groupmin as GM
    from tpu_knn_torch.spaces.dense import ensure_cert_metadata

    dev = torch.device("cuda", 0)
    out = {}
    th = time.perf_counter()
    hist = _histograms(N_CORPUS + N_QUERIES, DIM, seed=17)
    hx, hq = hist[:N_CORPUS], hist[N_CORPUS:]
    print(f"[dense] data: {N_CORPUS + N_QUERIES} x {DIM} Dirichlet(0.1) histograms in "
          f"{time.perf_counter() - th:.2f} s; {float((hist == 0).mean()):.3g} of the components are 0, "
          f"{float((hist < TINY).mean()):.3g} below 1e-30", flush=True)
    hq_dev, hx_dev = torch.from_numpy(hq).to(dev), torch.from_numpy(hx).to(dev)

    # ---- kldivgenfast, exact kNN over 1M histograms: two-pass, the f32 kernel ----
    idx = Index("kldivgenfast", Params(dim=DIM), method="seq_search", device="cuda")
    tb = time.perf_counter()
    idx.add_dense_batch(hx)
    idx.build_index()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    GM.reset_launches()
    dk, ik = idx.knn_query_batch(hq, K)
    launches = dict(GM.launches)
    m = idx.method
    _require(m.last_route == "twopass" and launches["float32"] == 1 and sum(launches.values()) == 1,
             lambda: f"kldivgenfast 1M: route {m.last_route}, launches {launches}")
    med, tmin, tmax = _median_ms(lambda: idx.knn_query_batch(hq, K))
    stages, qenc = _breakdown(idx, hq, K)
    print(f"[dense] kldivgenfast {N_CORPUS} x {DIM}: build {build_s:.3f} s; route {m.last_route}, launches per "
          f"knn_query_batch {launches}; knn_query_batch Q={N_QUERIES} k={K}: median {med:.3f} ms of 7 (min "
          f"{tmin:.3f}, max {tmax:.3f}), {N_QUERIES / med * 1e3:.1f} qps; device ms per stage "
          f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}; {smi}", flush=True)
    data = m.data
    q, qt, xt, scale = SS._kernel_inputs(idx.space, qenc, data)
    qt, xt = qt.contiguous(), xt.contiguous()
    k_out = GM.fused_groupmin(q, data.vecs, qt, xt, scale)
    ref = GM.fused_groupmin_reference(q.double(), data.vecs.double(), qt.double(), xt.double(), scale)
    bound, mag = _groupmin_bound(q, data.vecs, qt, xt, scale)
    err = (k_out.double() - ref).abs()
    ratio = float((err / bound).max())
    kms = _cuda_ms(lambda: GM.fused_groupmin(q, data.vecs, qt, xt, scale), 10)
    pms = _cuda_ms(lambda: GM.fused_groupmin_reference(q, data.vecs, qt, xt, scale), 3)
    kb = _bound_ms("float32", q, data.vecs)
    print(f"[kernel] f32 on the KL inputs Q={q.shape[0]} N={data.vecs.shape[0]} D={DIM} (q the histograms, x "
          f"log(max(x, 1e-30)) in [{float(data.vecs.min()):.4g}, {float(data.vecs.max()):.4g}], q_term "
          f"in [{float(qt.min()):.4g}, {float(qt.max()):.4g}]): max |kernel - f64 plain| {float(err.max()):.4g}, "
          f"max relative to the magnitude {float((err / mag).max()):.3g}, max error/bound {ratio:.3g}; kernel "
          f"{kms:.3f} ms, plain (f32) {pms:.3f} ms, bound {kb[0]:.3f} ms ({kb[1]}), {kb[0] / kms:.1%} of it; {smi}",
          flush=True)
    _require(ratio <= 1.0 and bool(torch.isfinite(k_out).all()), lambda: f"f32 kernel on the KL inputs: {ratio}")
    out["kldivgenfast"] = {"build_s": build_s, "ms": med, "stages": stages, "kernel_ms": kms, "plain_ms": pms,
                           "bound_ms": kb[0], "launches": launches["float32"], "max_abs_err": float(err.max())}
    del ref, err, bound, mag, k_out
    out["kldivgenfast"]["oracle_ties"] = _check_dense_oracle(
        f"kldivgenfast {N_CORPUS} rows", "kldivgenfast", ik, dk, hq_dev, hx_dev, K)
    # the reduced tiers under the certificate on the same inputs: the same results
    ensure_cert_metadata(data)
    f32 = GM.fused_groupmin(q, data.vecs, qt, xt, scale)
    _, mag = _groupmin_bound(q, data.vecs, qt, xt, scale)
    for tier in ("high", "bfloat16"):
        idx.build_index(Params(pass1Precision=tier))
        GM.reset_launches()
        dt, it = idx.knn_query_batch(hq, K)
        lt = dict(GM.launches)
        _same_results(f"kldivgenfast {tier}", dt, it, dk, ik)
        medt = _median_ms(lambda: idx.knn_query_batch(hq, K), 3)[0]
        data = idx.method.data
        ensure_cert_metadata(data)
        outt = GM.fused_groupmin(q, data.vecs, qt, xt, scale, precision=tier)
        reft = GM.fused_groupmin_reference(q, data.vecs, qt, xt, scale, precision=tier)
        rel = float(((outt.double() - reft.double()).abs() / mag).max())
        eps = SS._pass1_eps(q, data, scale, tier).double()
        er = float(((outt.double() - f32.double()).abs().amax(dim=1) / eps).max())
        print(f"[dense] kldivgenfast pass1Precision={tier}: certified {idx.method.last_certified:.6f}, redone blocks "
              f"{idx.method.last_redone_blocks} of {-(-N_QUERIES // SS._CERT_QBLK)}, launches {lt}; median "
              f"{medt:.3f} ms of 3 (f32 tier {med:.3f}); kernel vs plain {rel:.3g} of the magnitude (limit 1e-5), "
              f"max_g |kernel - f32 kernel| / eps {er:.3g}, eps median {float(eps.median()):.4g}; {smi}", flush=True)
        _require(rel <= 1e-5 and er <= 1.0, lambda: f"{tier} kernel on the KL inputs: {rel}, {er}")
        del outt, reft, eps
    del idx, m, data, qenc, q, qt, xt, f32, mag
    torch.cuda.empty_cache()

    # ---- l1 over phase 4's 1M sift_like rows: pass 1 on the elementwise kernel ----
    sass = _ew_sass(GM.build_all((EW.LIB,))[EW.LIB])
    for key, c in sorted(sass.items()):
        print(f"[dense] kernel {key}: inner loop {c['loop']} instructions for {c['pairs']} element pairs "
              f"(geometry {c['geometry']}); its fall-through path {c['path_per_pair']:.3f} an element pair, "
              f"{c['arith_per_pair']:.3f} of them arithmetic ({json.dumps(c['opcodes'])})"
              + (f"; the guarded loop (a negative or NaN value in the tile) {c['guarded_per_pair']:.3f}"
                 if "guarded_per_pair" in c else ""), flush=True)
    x_dev = torch.from_numpy(corpus).to(dev)
    li = Index("l1", Params(dim=DIM), method="seq_search", device="cuda")
    tb = time.perf_counter()
    li.add_dense_batch(corpus)
    li.build_index()
    torch.cuda.synchronize()
    build_l1 = time.perf_counter() - tb
    ew_totals = dict.fromkeys(GM.ELEMENTWISE, 0)
    ew_runs = {}
    plain_on_card = {}  # run -> calls of the plain versions on CUDA tensors in it (_PlainGuard)

    def ew_run(tag, fn):
        """``fn()`` with every launch count set to 0 just before it; returns (its result, every
        count just after). Keeps the elementwise kernel's counts as run ``tag``'s and adds them
        to the phase's totals; counts the plain versions' calls on CUDA tensors in it."""
        GM.reset_launches()
        with _PlainGuard() as guard:
            res = fn()
        got = dict(GM.launches)
        plain_on_card[tag] = guard.count
        ew_runs[tag] = {k: got[k] for k in GM.ELEMENTWISE}
        for k in GM.ELEMENTWISE:
            ew_totals[k] += got[k]
        return res, got

    def only(**counts):
        """The launch counts of a run that launched each key of ``counts`` that many times and
        nothing else."""
        return {k: counts.get(k, 0) for k in GM.launches}

    pass2_launches = -(-N_QUERIES // SS._PASS2_QBLK)  # one batched launch a 1024-query block
    (d1, i1), l1_launches = ew_run("l1 1M", lambda: li.knn_query_batch(queries, K))
    _require(li.method.last_route == "twopass" and l1_launches == only(elementwise_groupmin_l1=1,
                                                                       elementwise_batched_l1=pass2_launches),
             lambda: f"l1 1M: route {li.method.last_route}, launches {l1_launches}")
    med1, tmin1, tmax1 = _median_ms(lambda: li.knn_query_batch(queries, K))
    stages1, _ = _breakdown(li, queries, K)
    print(f"[dense] l1 {N_CORPUS} x {DIM} sift_like: build {build_l1:.3f} s; route {li.method.last_route} (pass 1 "
          f"one elementwise group-min launch, pass 2 one batched launch a {SS._PASS2_QBLK}-query block), launches "
          f"{ {k: v for k, v in l1_launches.items() if v} }; knn_query_batch Q={N_QUERIES} k={K}: "
          f"median {med1:.3f} ms of 7 (min {tmin1:.3f}, max {tmax1:.3f}), {N_QUERIES / med1 * 1e3:.1f} qps; "
          f"device ms per stage {json.dumps({k: round(v, 4) for k, v in stages1.items()})}; {smi}", flush=True)
    nq1 = 256
    _check_dense_oracle(f"l1 {N_CORPUS} rows", "l1", i1[:nq1], d1[:nq1],
                        torch.from_numpy(queries[:nq1]).to(dev), x_dev, K)
    out["l1"] = {"build_s": build_l1, "ms": med1, "stages": stages1}
    # pass 1's own launch shape: every group min against the plain version
    ew_main = {"l1 1M": _ew_main_check(smi, "l1 1M cell", li, queries, 1.0, sass)}
    del li
    torch.cuda.empty_cache()

    # ---- the elementwise kernel against its plain versions: edge sweep, 65,536 rows ----
    runs, zeros = _ew_edge_sweep()
    print(f"[dense] kernel edge sweep: {runs} runs (l1, linf, lp at p {', '.join(f'{p:g}' for p in EW_SWEEP_P)}, "
          f"js, jsmetr; both epilogues; Q 1, 7, 130; N 128, 384 / 100, 356; D 8, 20 (zero columns appended), "
          f"24, 136; NaN, +-inf and zero cells, 1e30 pads; JS self pairs): each NaN cell for NaN cell, linf "
          f"bit-equal, the others within rtol {EW_RTOL}; the {zeros} self-pair cells the plain version makes "
          f"0 are 0.0 in the kernel", flush=True)
    q_all = torch.from_numpy(queries).to(dev)
    out["ew_kernel"] = _ew_kernel_check(smi, x_dev, q_all, hx_dev, hq_dev, sass)
    runs_b = _ew_batched_sweep()
    huge = _ew_js_huge()
    print(f"[dense] kernel batched edge sweep: {runs_b} runs (l1, linf, lp at p {', '.join(f'{p:g}' for p in EW_SWEEP_P)}, "
          f"js, jsmetr; B 3, (Cq, K) {list(EW_SWEEP_CK + EW_SWEEP_PAIRS)}; D 8, 20 (zero columns appended), 136; histograms, signed "
          f"normals and tiny cells; NaN, +-inf and zero cells, +inf and 1e30 pads): each NaN cell for NaN cell, "
          f"linf bit-equal, the others within rtol {EW_RTOL}; the JS pair of two 2e38 cells "
          f"{json.dumps(huge)} (tpu_knn's {EW_JS_HUGE:.7g}, finite in every epilogue)", flush=True)
    out["ew_batched"] = _ew_batched_check(smi, x_dev, q_all, hx_dev, hq_dev)
    out["ew_batched"]["edge_runs"], out["ew_batched"]["js_huge"] = runs_b, huge
    del q_all, x_dev
    torch.cuda.empty_cache()

    # ---- jsdivfast and renyidiv_fast over the 1M histograms ----
    nqj = 256
    for name in ("jsdivfast", "renyidiv_fast"):
        ix = Index(name, Params(DENSE_PARAMS.get(name, {})), method="seq_search", device="cuda")
        ix.add_dense_batch(hx)
        ix.build_index()
        (dj, ij), lj = ew_run(f"{name} 1M", lambda: ix.knn_query_batch(hq[:nqj], K))
        want_l = only(**({"elementwise_groupmin_js": 1, "elementwise_batched_js": 1}
                         if ix.space.pass1_elementwise() else {}))
        _require(ix.method.last_route == "twopass" and lj == want_l,
                 lambda: f"{name}: route {ix.method.last_route}, launches {lj}")
        medj, tminj, tmaxj = _median_ms(lambda: ix.knn_query_batch(hq[:nqj], K), 3)
        print(f"[dense] {name} {N_CORPUS} x {DIM}: route {ix.method.last_route}, launches {lj}, "
              f"knn_query_batch Q={nqj} k={K}: median {medj:.3f} ms of 3 (min {tminj:.3f}, max {tmaxj:.3f}), "
              f"{nqj / medj * 1e3:.1f} qps; {smi}", flush=True)
        _check_dense_oracle(f"{name} {N_CORPUS} rows", name, ij, dj, hq_dev[:nqj], hx_dev, K)
        out[name] = {"ms": medj, "queries": nqj}
        if name == "jsdivfast":
            ew_main["jsdivfast 1M"] = _ew_main_check(smi, "jsdivfast 1M cell", ix, hq[:nqj], None, sass)
        del ix
        torch.cuda.empty_cache()

    # ---- every name at 20,000 rows, both routes, and lp at p=0.7 (the elementwise kernel's MUFU
    # route); range on l1 and kldivgenfast ----
    n2, nq2 = 20_000, 256
    routes = {}
    cells = [(name, name, DENSE_PARAMS.get(name, {})) for name in DENSE_NAMES] + [("lp p=0.7", "lp", {"p": 0.7})]
    for label, name, params in cells:
        src, qsrc = (corpus, queries) if name in ("l1", "dummy", "linf", "lp") else (hx, hq)
        xs_dev = torch.from_numpy(src[:n2]).to(dev)
        qs_dev = torch.from_numpy(qsrc[:nq2]).to(dev)
        for n, want in ((n2, "twopass"), (3000, "single")):
            ix = Index(name, Params(params), method="seq_search", device="cuda")
            ix.add_dense_batch(src[:n])
            (d, i), lw = ew_run(f"{label} {want}", lambda: ix.knn_query_batch(qsrc[:nq2], K))
            _require(ix.method.last_route == want, lambda: f"{label} {n} rows: route {ix.method.last_route}")
            affine = ix.space.pass1_affine() is not None
            ew = ix.space.pass1_elementwise()
            # pass 1 one group-min launch and pass 2 one batched launch, or the single pass one
            # distance launch a chunk
            want_ew = dict.fromkeys(GM.ELEMENTWISE, 0)
            if ew is not None and want == "twopass":
                want_ew[EW.launch_key("groupmin", ew[0])] = 1
                want_ew[EW.launch_key("batched", ew[0])] = -(-nq2 // SS._PASS2_QBLK)
            elif ew is not None:
                want_ew[EW.launch_key("dists", ew[0])] = ix.method.data.ids.shape[0] // ix.method._chunk
            _require((lw["float32"] > 0) == (affine and want == "twopass") and ew_runs[f"{label} {want}"] == want_ew,
                     lambda: f"{label} {n} rows: launches {lw}, want elementwise {want_ew}")
            _check_dense_oracle(f"{label} {want} route, {n} rows", name, i, d, qs_dev, xs_dev[:n], K, params)
            routes[f"{label} {want}"] = lw["float32"] + sum(want_ew.values())
            if label == "l1" and want == "twopass":
                l1_exact = (d, i)  # the 20,000-row methods below are held to these ids
            if ew is not None:  # the launches this run made, on its own tensors
                _ew_hold_index(f"{label} {want} route, {n} rows", ix, qsrc[:nq2], want)
            if n == n2 and name in ("l1", "kldivgenfast"):
                _, lr = ew_run(f"{name} range", lambda: _dense_range_check(name, ix, qsrc[:nq2], qs_dev, xs_dev, d))
                _require((lr["elementwise_dists_l1"] > 0) == (name == "l1"), lambda: f"range {name}: launches {lr}")
            del ix
        del xs_dev, qs_dev
    print(f"[dense] the elementwise kernel held against its plain version on the tensors of every "
          f"elementwise name's two-pass and single-pass runs above, within rtol {EW_RTOL} (linf bit-equal)",
          flush=True)
    out["routes"] = routes
    torch.cuda.empty_cache()

    # ---- HNSW: the default index over 20,000 histograms, waves (cut from 100,000: the cell has
    # no recall floor, i.i.d. Dirichlet rows set the recall) ----
    nh = 20_000
    hi = Index("kldivgenfast", Params(dim=DIM), device="cuda")  # no method=: hnsw
    hi.add_dense_batch(hx[:nh])
    torch.cuda.synchronize()
    tb = time.perf_counter()
    hi.build_index(Params(M=16, efConstruction=200, waveSize=1024))
    torch.cuda.synchronize()
    build_h = time.perf_counter() - tb
    hm = hi.method
    chk = hm.check_graph()
    print(f"[dense] hnsw kldivgenfast {nh} x {DIM}, M=16 efConstruction=200 waveSize=1024 (buildAlgo "
          f"{hm._resolve_build_algo(nh)}, NN-descent eligible {hm._nnd_eligible()}, construction store "
          f"{bool(hm.construction_store) and hm._cstore_ok()}): build {build_h:.2f} s, check_graph {chk}; {smi}",
          flush=True)
    gd, gi = GoldStandard(hi.space, hi.store).compute_knn(hq, K)
    rows = {}
    for ef in (20, 100, 400, 1000):
        hi.set_query_time_params(Params(efSearch=ef))
        dh, ih = hi.knn_query_batch(hq, K)
        best = _median_ms(lambda: hi.knn_query_batch(hq, K), reps=3)[1]
        # every returned distance is its id's f64 distance
        dret, sret = _dense_pairs("kldivgenfast", hq_dev, hx_dev, torch.as_tensor(ih.astype(np.int64), device=dev))
        lim = (DIM + 8) * U * sret + 8 * U * dret.abs()
        dist_ok = bool(((torch.as_tensor(dh, device=dev).double() - dret).abs() <= lim).all())
        rows[ef] = {"recall": _recall_at(ih, gi, K), "ms": best, "qps": N_QUERIES / best * 1e3}
        print(f"[dense] hnsw kldivgenfast {nh} x {DIM} efSearch={ef}: recall@{K} {rows[ef]['recall']:.4f} against "
              f"the exact ids, best of 3 {best:.2f} ms, {rows[ef]['qps']:.0f} qps; distances exact {dist_ok}; {smi}",
              flush=True)
        _require(dist_ok and (ih >= 0).all(), lambda: f"hnsw kldivgenfast efSearch={ef}: a distance off its f64 value")
    zero = {"self_links": 0, "dup_links": 0, "oob_links": 0}
    recalls = [r["recall"] for r in rows.values()]
    # i.i.d. histograms have no neighbourhood structure: at these settings
    # over 3000 of them the port's recall@10 equals tpu_knn's on the CPU,
    # 0.4848 at efSearch=20 (tests/test_torch_dense_spaces.py), so recall
    # is printed and held to rise with the beam; the distances are exact
    _require(chk == zero and all(b >= a - 0.01 for a, b in zip(recalls, recalls[1:])),
             lambda: f"hnsw kldivgenfast: check_graph {chk}, recall@10 over efSearch {recalls}")
    out["hnsw_kldivgenfast"] = {"build_s": build_h, "search": rows}
    del hi, hm
    torch.cuda.empty_cache()

    # ---- HNSW over l1 at 20,000 rows: the batched epilogue's beam and pairs ----
    li = Index("l1", Params(dim=DIM), device="cuda")
    li.add_dense_batch(corpus[:n2])
    tb = time.perf_counter()
    with _BatchedShapes() as shapes:
        _, hl = ew_run("hnsw l1", lambda: li.build_index(Params(M=16, efConstruction=100, waveSize=1024)))
    torch.cuda.synchronize()
    build_hl = time.perf_counter() - tb
    pairs_hl = {ck: n for ck, n in shapes.counts.items() if ck[0] > 1}
    for c in EW_PAIR_SHAPES:
        ew_runs[f"hnsw l1 pairs {c}x{c}"] = {"elementwise_batched_l1": pairs_hl.get((c, c), 0)}
    chk = li.method.check_graph()
    _, gl = GoldStandard(li.space, li.store).compute_knn(queries[:nq2], K)
    li.set_query_time_params(Params(efSearch=100))
    (ds, is_), _ = ew_run("hnsw l1 search", lambda: li.knn_query_batch(corpus[:256], K))
    self_first = float(np.mean(is_[:, 0] == np.arange(256)))
    rec = _recall_at(li.knn_query_batch(queries[:nq2], K)[1], gl, K)
    print(f"[dense] hnsw l1 {n2} x {DIM}, M=16 efConstruction=100 waveSize=1024: build {build_hl:.2f} s (launches "
          f"{ {k: v for k, v in hl.items() if v} }; batched calls by (Cq, K), Cq > 1: "
          f"{json.dumps({f'{a}x{b}': n for (a, b), n in sorted(pairs_hl.items())})}, Cq = 1: "
          f"{sum(n for ck, n in shapes.counts.items() if ck[0] == 1)}), check_graph {chk}, self-query first "
          f"{self_first:.4f}, recall@{K} at efSearch=100 {rec:.4f}; {smi}", flush=True)
    _require(chk == zero and self_first == 1.0 and rec >= 0.9 and hl["elementwise_batched_l1"] > 0
             and sum(pairs_hl.values()) > 0 and sum(shapes.counts.values()) == hl["elementwise_batched_l1"],
             lambda: f"hnsw l1: check_graph {chk}, self-query first {self_first}, recall {rec}, launches {hl}, "
                     f"batched calls {shapes.counts}")
    out["hnsw_l1"] = {"build_s": build_hl, "recall": rec, "batched_launches": hl["elementwise_batched_l1"],
                      "pair_launches": {f"{a}x{b}": n for (a, b), n in sorted(pairs_hl.items())}}
    del li
    torch.cuda.empty_cache()

    # ---- l1 at 20,000 rows through the other methods, held to the two-pass scan's ids ----
    out["l1_methods"] = {}
    ex_d, _ = l1_exact
    for label, method, build, qp, floor in (
            ("vptree", "vptree", {}, {}, 0.99),  # the exact pruner: l1 is a metric
            ("napp", "napp", {"numPivot": 256, "numPrefix": 32}, {"minTimes": 2}, 0.9),
            ("sw-graph", "sw-graph", {"NN": 16, "efConstruction": 100, "waveSize": 1024}, {"efSearch": 100}, 0.9),
            # NN-descent needs an affine form (hnsw._nnd_eligible, as tpu_knn's): this build takes the waves
            ("nndescent", "hnsw", {"M": 16, "efConstruction": 64, "waveSize": 1024, "buildAlgo": "nndescent"},
             {"efSearch": 100}, 0.9)):
        ix = Index("l1", Params(dim=DIM), method=method, device="cuda")
        ix.add_dense_batch(corpus[:n2])
        tb = time.perf_counter()
        _, lb = ew_run(f"l1 {label}", lambda: ix.build_index(Params(build)))
        torch.cuda.synchronize()
        bs = time.perf_counter() - tb
        ix.set_query_time_params(Params(qp))
        (dm, im), lq = ew_run(f"l1 {label} search", lambda: ix.knn_query_batch(queries[:nq2], K))
        # the scan's pass 2 (batched epilogue) and these methods' scorers (the distance epilogue
        # too) sum in different orders: a k-th neighbour may come back an ulp or so above its
        # scan distance, so the tie bound takes the f32 bound of a D-term sum
        rec = _tie_recall(dm, ex_d, K, (DIM + 8) * U)
        ew_l = {k: lb[k] + lq[k] for k in GM.ELEMENTWISE if lb[k] + lq[k]}
        extra = f", NN-descent eligible {ix.method._nnd_eligible()}" if method == "hnsw" else ""
        print(f"[dense] l1 {method} {n2} x {DIM} {json.dumps(build)} {json.dumps(qp)}: build {bs:.2f} s{extra}; "
              f"tie-aware recall@{K} against the two-pass scan's {rec:.4f} (floor {floor}); elementwise launches "
              f"{json.dumps(ew_l)}; {smi}", flush=True)
        _require(rec >= floor and sum(ew_l.values()) > 0 and (method != "hnsw" or not ix.method._nnd_eligible()),
                 lambda: f"l1 {label}: recall {rec}, launches {ew_l}")
        out["l1_methods"][label] = {"build_s": bs, "recall": rec, "launches": ew_l}
        del ix
        torch.cuda.empty_cache()

    _require(all(c > 0 for c in ew_totals.values()),
             lambda: f"an elementwise kernel instance never launched on phase 17's paths: {ew_totals}")
    _require(sum(plain_on_card.values()) == 0,
             lambda: f"a plain version ran on CUDA tensors in phase 17's index runs: "
                     f"{ {k: v for k, v in plain_on_card.items() if v} }")
    # each record row's launches and numbers come from the run that row names
    out["ew_record"] = {}
    for key, (counter, run, numbers) in EW_RECORD.items():
        r = ew_main.get(numbers) or out["ew_batched"].get(numbers) or out["ew_kernel"][numbers][key.split("_")[1]]
        out["ew_record"][key] = {**r, "launches": ew_runs[run][counter], "launches_from": run}
        _require(ew_runs[run][counter] > 0, lambda: f"{key}: no launch in the run {run!r}: {ew_runs[run]}")
    print(f"[dense] elementwise kernel launches on phase 17's paths, all runs {json.dumps(ew_totals)}; calls of "
          f"the plain versions on CUDA tensors in its {len(plain_on_card)} index runs: "
          f"{sum(plain_on_card.values())}; the kernels record's launches, each from its own run "
          f"{json.dumps({k: [v['launches_from'], v['launches']] for k, v in out['ew_record'].items()})}; its "
          f"numbers from the shapes {json.dumps({k: v['shape'] for k, v in out['ew_record'].items()})}",
          flush=True)
    out["plain_on_card"] = sum(plain_on_card.values())
    return out


def _dense_range_check(name, ix, qpts, q_dev, x_dev, d10):
    """range_query_batch at the median 10th-neighbour distance against the
    float64 oracle: every point whose f64 distance lies beyond 2B of the
    radius is in or out as the oracle says; returned distances within B
    of their ids' f64 distances."""
    import torch

    radius = float(np.median(d10[:, K - 1]))
    res = ix.range_query_batch(qpts, radius)
    dev = q_dev.device
    q64 = q_dev.double()
    undecided = wrong = 0
    for r, hit in enumerate(res):
        d, s = _dense_f64(name, q64[r:r + 1], x_dev.double())
        d, b = d[0], (q_dev.shape[1] + 8) * U * s[0]
        inside = torch.zeros_like(d, dtype=torch.bool)
        ids = torch.as_tensor(hit.ids.astype(np.int64), device=dev)
        inside[ids] = True
        sure = (d - radius).abs() > 2.0 * b
        wrong += int(((inside != (d <= radius)) & sure).sum())
        undecided += int((~sure).sum())
        got = torch.as_tensor(hit.dists, device=dev).double()
        _require(bool(((got - d[ids]).abs() <= b[ids] + 8 * U * got.abs()).all()),
                 lambda: f"range {name}: query {r} has a distance beyond the f32 bound")
    _require(wrong == 0, lambda: f"range {name}: {wrong} points in or out against the f64 oracle")
    print(f"[oracle] range {name} {x_dev.shape[0]} rows, radius {radius:.6g}: {sum(len(h.ids) for h in res)} hits "
          f"over {len(res)} queries, every point beyond 2B of the radius in or out as the f64 oracle says "
          f"({undecided} within it)", flush=True)


# ---------------- phase 18: the sparse spaces ----------------

#: each sparse name, the parameters the phase gives it, and its f64 oracle
SPARSE_NAMES = {
    "cosinesimil_sparse": "cosine", "cosinesimil_sparse_fast": "cosine",
    "cosinesimil_sparse_bin_fast": "cosine_bin", "angulardist_sparse": "angular",
    "angulardist_sparse_fast": "angular", "negdotprod_sparse": "negdot", "negdotprod_sparse_fast": "negdot",
    "negdotprod_sparse_bin_fast": "negdot_bin", "querynorm_negdotprod_sparse": "querynorm",
    "querynorm_negdotprod_sparse_fast": "querynorm", "l1_sparse": "l1", "l2_sparse": "l2",
    "linf_sparse": "linf", "lp_sparse": "lp3", "sparse_jaccard": "jaccard", "jaccard_sparse": "jaccard",
}


def _csr64(points, vocab: int):
    """scipy CSR float64 [n, vocab] of (1-based ids, values) points."""
    import scipy.sparse as sp

    lens = np.fromiter((len(p[0]) for p in points), np.int64, len(points))
    indptr = np.concatenate([[0], np.cumsum(lens)])
    cols = np.concatenate([p[0] for p in points]).astype(np.int64) - 1
    vals = np.concatenate([p[1] for p in points]).astype(np.float64)
    return sp.csr_matrix((vals, cols, indptr), shape=(len(points), vocab))


def _sparse_f64(kind: str, q, x):
    """Distances float64 [Q, N] of the CSR queries ``q`` to the CSR rows
    ``x`` by the reference formulas (space_sparse_*.h), and a bound f64
    [Q, N] on the error of an f32 evaluation of them: 4 (2 nnz + 16) u
    times the magnitudes the sums run over."""
    if kind.endswith("_bin"):
        q, x, kind = q.copy(), x.copy(), kind[:-4]
        q.data[:], x.data[:] = 1.0, 1.0
    nnz = max(int(np.diff(x.indptr).max()), int(np.diff(q.indptr).max()))
    c = 4.0 * (2 * nnz + 16) * U
    if kind in ("cosine", "angular", "negdot", "querynorm", "jaccard"):
        if kind == "jaccard":
            q, x = q.copy(), x.copy()
            q.data[:], x.data[:] = 1.0, 1.0
        dot = (q @ x.T.tocsc()).toarray()  # sparse times sparse: the posting lists of the query terms
        qn = np.sqrt(np.asarray(q.multiply(q).sum(1)))
        xn = np.sqrt(np.asarray(x.multiply(x).sum(1))).T
        if kind == "jaccard":
            ql, xl = np.diff(q.indptr)[:, None], np.diff(x.indptr)[None, :]
            union = ql + xl - dot
            return np.where(union > 0, 1.0 - dot / np.maximum(union, 1), 0.0), c * np.ones_like(dot)
        mag = qn * xn
        if kind == "negdot":
            return -dot, c * mag
        if kind == "querynorm":
            return -dot / np.maximum(qn, 1e-10), c * xn * np.ones_like(dot)
        cos = dot / np.maximum(mag, 1e-10)
        if kind == "cosine":
            return np.maximum(0.0, 1.0 - cos), c * np.ones_like(dot)
        # arccos is steep near +-1: its bound grows as 1/sqrt(1 - cos^2)
        return np.arccos(np.clip(cos, -1.0, 1.0)), c / np.sqrt(np.maximum(1.0 - cos**2, c))
    # the Lp family over the union of the supports, a block of queries at a time
    xc = x.tocsc()
    out = np.empty((q.shape[0], x.shape[0]))
    mag = np.empty_like(out)
    rows = np.repeat(np.arange(x.shape[0]), np.diff(x.indptr))
    p = {"l1": 1.0, "l2": 2.0, "lp3": 3.0, "linf": np.inf}[kind]
    for r in range(q.shape[0]):
        qd = q[r].toarray()[0]
        qv = qd[x.indices]
        ax = np.abs(x.data - qv)
        if np.isinf(p):  # every row holds an element: reduceat sees no empty segment
            m_x = np.maximum.reduceat(ax, x.indptr[:-1])
            qi = q[r].indices
            present = (xc[:, qi] != 0).toarray() if len(qi) else np.zeros((x.shape[0], 0), bool)
            m_q = np.max(np.where(present, 0.0, np.abs(q[r].data)[None, :]), axis=1, initial=0.0)
            out[r] = np.maximum(m_x, m_q)
            mag[r] = out[r]
            continue
        term = np.bincount(rows, ax**p - np.abs(qv) ** p, x.shape[0]) + np.sum(np.abs(q[r].data) ** p)
        s = np.maximum(term, 0.0)
        out[r] = s ** (1.0 / p)
        # the sum of the |terms| bounds its rounding; the root divides it by p
        mag[r] = (np.bincount(rows, ax**p + np.abs(qv) ** p, x.shape[0]) + np.sum(np.abs(q[r].data) ** p)) \
            / (p * np.maximum(s, 1e-30) ** (1.0 - 1.0 / p))
    return out, c * mag


def _check_sparse_knn(label, ids, dists, d64, b64, k: int):
    """Held to the float64 oracle: every returned distance within rtol 5e-3
    (and the f32 bound) of its id's f64 distance, and the returned ids a
    top-k of the oracle up to ties: the i-th returned f64 distance within
    twice the bound of the oracle's i-th. Returns (ids that differ from the
    oracle's, largest |returned - f64|)."""
    _require(ids.shape == (d64.shape[0], k) and bool((ids >= 0).all()),
             lambda: f"{label}: ids {ids.shape} or a missing id")
    rows = np.arange(ids.shape[0])[:, None]
    got64 = d64[rows, ids]
    err = np.abs(dists.astype(np.float64) - got64)
    _require(bool(np.all(err <= np.maximum(5e-3 * np.abs(got64) + 1e-5, b64[rows, ids]))),
             lambda: f"{label}: a distance off its id's f64 value by {float(err.max()):.3g}")
    order = np.argsort(d64, axis=1, kind="stable")[:, :k]
    want = d64[rows, order]
    tol = 2.0 * np.maximum(b64[rows, order], b64[rows, ids])
    _require(bool(np.all(np.abs(np.sort(got64, axis=1) - want) <= tol + 1e-12)),
             lambda: f"{label}: the returned ids are not a top-{k} of the f64 oracle up to ties")
    return int(np.sum(np.sort(ids, 1) != np.sort(order, 1))), float(err.max())


def _check_sparse_range(label, res, d64, b64, radius: float):
    """range results against the oracle: every point beyond twice the bound
    from the radius in or out as the oracle says, distances within the
    bound. Returns (hits, undecided points)."""
    wrong = undecided = hits = 0
    for r, hit in enumerate(res):
        inside = np.zeros(d64.shape[1], bool)
        inside[hit.ids] = True
        sure = np.abs(d64[r] - radius) > 2.0 * b64[r]
        wrong += int(np.sum((inside != (d64[r] <= radius)) & sure))
        undecided += int(np.sum(~sure))
        hits += len(hit.ids)
        _require(bool(np.all(np.abs(hit.dists - d64[r, hit.ids]) <= np.maximum(b64[r, hit.ids], 1e-6))),
                 lambda: f"{label}: query {r} has a range distance off its f64 value")
    _require(wrong == 0, lambda: f"{label}: {wrong} points in or out against the f64 oracle")
    return hits, undecided


def _timed_knn(idx, pts, k: int, reps: int, agg):
    """(agg of ``reps`` synced walls in seconds, dists, ids) after one warm call."""
    import torch

    idx.knn_query_batch(pts, k)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        d, i = idx.knn_query_batch(pts, k)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return agg(walls), d, i


#: csrc/sparse_qdense.cu's checks: (label, form, 0/1 values); the 0/1 forms and Jaccard sum
#: integers, so the kernel must equal its plain version there
SQ_CASES = (("negdot", "negdot", False), ("querynorm", "querynorm", False), ("cosine", "cosine", False),
            ("angular", "angular", False), ("negdot_bin", "negdot", True), ("cosine_bin", "cosine", True),
            ("jaccard", "jaccard", True))


def _sq_products(post, xcol) -> int:
    """The non-zero products of one launch: over the real corpus elements of ``xcol``, the queries
    of ``post`` that hold each element's id (the records of its term in every tile)."""
    import torch
    from tpu_knn_torch.ops import sparse as S

    real = (xcol >= 1) & (xcol < S.PAD_X)
    term = (torch.clamp(xcol, 1, post.v).long() - 1)[real]
    ptr = post.ptr.long()
    return int((ptr[(term + 1) * post.tiles] - ptr[term * post.tiles]).sum())


def _sq_bound_ms(elements: int, products: int, records: int, nq: int, v: int, rows: int):
    """(ms, by) of the least time for csrc/sparse_qdense.cu's work: each real corpus element's id
    and value (8 B), the postings' records (8 B) and pointers, pad and the [Q, rows] output moved
    once at 3.35 TB/s, against one multiply-add a non-zero product (a real element and a query that
    holds its id) at the 67 TFLOP/s FP32 peak."""
    from tpu_knn_torch.ops import sparse as S

    tiles = max(1, -(-nq // S.POST_TILE))
    nbytes = 8 * elements + 8 * records + 4 * (v * tiles + 1) + 4 * rows + 4 * nq * rows
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * products / PEAK_OPS["float32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _sq_bound_dense_ms(elements: int, nq: int, v: int, rows: int):
    """The bound of a gather of the dense table, printed beside it: the [V, Q] table read once
    and one multiply-add a (real element, query) pair, zero or not."""
    nbytes = 8 * elements + 4 * v * nq + 4 * rows + 4 * nq * rows
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * elements * nq / PEAK_OPS["float32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _sq_inputs(label, qenc, xc, binary: bool):
    """(postings, w, qn) of one check: the scan's own postings, values and query norms, or their 0/1
    forms (the _bin_fast names' encodings; Jaccard reads the presence values)."""
    from tpu_knn_torch.ops import sparse as S

    if label == "jaccard" or binary:
        vals = (qenc["qval"] != 0).float()
        return S.postings(qenc["qcol"], vals, qenc["q_post"].v), (xc["x"] != 0).float(), S.norms_from_vals(vals)
    return qenc["q_post"], xc["x"], qenc["qnorm"]


def _sq_compare(label, got, ref, exact: bool) -> float:
    """The kernel's distances against its plain version's: NaN where the plain version has NaN (a
    non-finite corpus weight), elsewhere equal for the integer sums, else within rtol 5e-3 and atol
    1e-5 (an angular distance also passes with its cosine within 1e-6, the repository's rule:
    arccos is ill-conditioned near 0). Returns max |got - ref| over the finite cells."""
    import torch

    _require(got.shape == ref.shape, lambda: f"{label}: shape {tuple(got.shape)} against {tuple(ref.shape)}")
    nan = torch.isnan(ref)
    _require(bool(torch.equal(torch.isnan(got), nan)),
             lambda: f"{label}: NaN in {int((torch.isnan(got) != nan).sum())} cells where the plain version differs")
    if exact:
        _require(bool(torch.equal(got[~nan], ref[~nan])),
                 lambda: f"{label}: the kernel differs from its plain version in {int((got != ref).sum())} cells")
        return 0.0
    ok = torch.isclose(got, ref, rtol=5e-3, atol=1e-5) | nan
    if "angular" in label:
        ok |= (torch.cos(got.double()) - torch.cos(ref.double())).abs() <= 1e-6
    _require(bool(ok.all()), lambda: f"{label}: {int((~ok).sum())} cells beyond rtol 5e-3 of the plain version, "
                                     f"max |diff| {float((got - ref)[~nan].abs().max()):.3g}")
    diff = (got - ref)[torch.isfinite(ref)].abs()
    return float(diff.max()) if diff.numel() else 0.0


def _sq_check_forms(label, qenc, xc) -> dict:
    """Every case of SQ_CASES against the plain version on one query batch and row slice; max |diff|."""
    from tpu_knn_torch.ops import sparse as S

    errs = {}
    with _PlainGuard.paused():
        for case, form, binary in SQ_CASES:
            post, w, qn = _sq_inputs(case, qenc, xc, binary)
            args = (form, post, xc["cols"], w, qn, qenc["qlen"], xc["len"], xc["pad"])
            errs[case] = _sq_compare(f"sparse kernel {label} {case}", S.qdense_dists(*args),
                                     S.qdense_dists_reference(*args), binary or form == "jaccard")
    return errs


def _device_ms(fn, key: str):
    """The device time (ms) of the kernels whose name holds ``key`` in one call of ``fn`` (after a
    warm one), from torch.profiler's CUDA trace: a loop of short launches that the host enqueues
    slower than the card runs them is timed by its own events at the host's rate. None when the
    trace holds no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) for e in prof.key_averages()
             if key in e.key)
    return us / 1e3 if us else None


def _sq_library_ms(post, xc, chunk: int) -> float:
    """torch.sparse.mm of the dots alone (CSR rows times the densified [V, Q] table, which the scan
    never builds), CUDA events, mean of 20."""
    import torch
    from tpu_knn_torch.ops import sparse as S

    real = (xc["cols"] >= 1) & (xc["cols"] < S.PAD_X)
    crow = torch.cat([real.new_zeros(1, dtype=torch.int64), torch.cumsum(real.sum(1), 0)])
    with _PlainGuard.paused():
        table = S.postings_table(post)
    xs = torch.sparse_csr_tensor(crow, xc["cols"][real].long() - 1, xc["x"][real], size=(chunk, post.v))
    return _cuda_ms(lambda: torch.sparse.mm(xs, table), 20)


def _sq_cell(smi, label, ix, queries, full: bool) -> dict:
    """csrc/sparse_qdense.cu at one cell's scan chunk (its first chunk of rows against the cell's
    queries) in every form against its plain version, with the kernel's, the plain version's and
    ``torch.sparse.mm``'s times at that shape (the dots alone, CSR rows times the densified table),
    and its bound beside a dense-table gather's; with ``full``, also both over every chunk of the cell's corpus, the
    kernel's own launches of the scan."""
    from tpu_knn_torch.ops import sparse as S

    space, data, chunk = ix.method.space, ix.method.data, ix.method._chunk
    xc = space.slice_data(data, 0, chunk)
    qenc = space.densify_queries(space.encode_queries(queries), xc, scan=True)
    post = qenc["q_post"]
    nq, v = post.nq, post.v
    errs = _sq_check_forms(label, qenc, xc)
    args = ("cosine", post, xc["cols"], xc["x"], qenc["qnorm"], None, None, xc["pad"])
    with _PlainGuard.paused():
        ms = _cuda_ms(lambda: S.qdense_dists(*args), 20)
        plain_ms = _cuda_ms(lambda: S.qdense_dists_reference(*args), 5)
    real = (xc["cols"] >= 1) & (xc["cols"] < S.PAD_X)
    e, prods, recs = int(real.sum()), _sq_products(post, xc["cols"]), int(post.ptr[-1])
    lib_ms = _sq_library_ms(post, xc, chunk)
    bound, by = _sq_bound_ms(e, prods, recs, nq, v, chunk)
    bd, byd = _sq_bound_dense_ms(e, nq, v, chunk)
    out = {"shape": [nq, chunk, xc["cols"].shape[1], v], "max_abs_err": max(errs.values()), "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound, "bound_by": by, "products": prods,
           "records": recs}
    print(f"[sparse] kernel {label}: {nq} queries x {chunk} rows x {xc['cols'].shape[1]} slots, vocab {v}, {e} "
          f"elements, {prods} non-zero products, {recs} query records; every form against its plain version ("
          + ", ".join(f"{c} {x:.3g}" for c, x in errs.items())
          + f" max |diff|; the 0/1 forms and jaccard equal); cosine {ms:.4f} ms a launch (mean of 20), plain "
          f"{plain_ms:.4f} ms, torch.sparse.mm of the dots alone {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}, "
          f"{bound / ms:.1%}; a dense-table gather's, every pair's FMA and the table: {bd:.4f} ms, {byd}, "
          f"{bd / ms:.1%}); {smi}", flush=True)
    if full:  # the scan's launches over every chunk of the corpus
        qn, n_pad = qenc["qnorm"], data.ids.shape[0]
        sl = [space.slice_data(data, s, chunk) for s in range(0, n_pad, chunk)]

        def scan(fn):
            return lambda: [fn("cosine", post, x["cols"], x["x"], qn, None, None, x["pad"]) for x in sl]

        with _PlainGuard.paused():
            out["full_ms"] = _cuda_ms(scan(S.qdense_dists), 5)
            out["full_device_ms"] = _device_ms(scan(S.qdense_dists), "sparse_qdense")
            out["full_plain_ms"] = _cuda_ms(scan(S.qdense_dists_reference), 1)
        e_all = int(data.length.sum())
        p_all = sum(_sq_products(post, x["cols"]) for x in sl)
        out["full_bound_ms"], out["full_bound_by"] = _sq_bound_ms(e_all, p_all, recs, nq, v, n_pad)
        bd, byd = _sq_bound_dense_ms(e_all, nq, v, n_pad)
        out["full_elements"], out["full_products"] = e_all, p_all
        dev = out["full_device_ms"]
        kern = dev or out["full_ms"]
        print(f"[sparse] kernel {label} over all {n_pad} rows ({len(sl)} launches, {e_all} elements, {p_all} non-zero "
              f"products): {out['full_ms']:.3f} ms by CUDA events through the wrapper (mean of 5), the kernel's device "
              f"time {'not measured (no profiler trace)' if dev is None else f'{dev:.3f} ms (torch.profiler)'}, plain "
              f"{out['full_plain_ms']:.3f} ms, bound {out['full_bound_ms']:.3f} ms ({out['full_bound_by']}, "
              f"{out['full_bound_ms'] / kern:.1%}; a dense-table gather's {bd:.3f} ms, {byd}, {bd / kern:.1%}); {smi}",
              flush=True)
    return out


def _sq_dense_cell(smi) -> dict:
    """The dense-table shape, where most table cells are non-zero: sparse_like(100_512,
    vocab=1_024, nnz=64, seed=0), 100,000 rows against 512 queries. Every form against its plain
    version at the first 4080-row chunk, then the cosine kernel, its plain version and
    torch.sparse.mm, one launch and over the 25 chunks of the corpus."""
    import torch
    from tpu_knn_torch import DataKind, Index
    from tpu_knn_torch.eval.datasets import sparse_like
    from tpu_knn_torch.ops import sparse as S

    n, nq = 100_000, 512
    pts = sparse_like(n + nq, vocab=1_024, nnz=64, seed=0)
    ix = Index("cosinesimil_sparse", method="seq_search", data_type=DataKind.SPARSE, device="cuda")
    ix.add_sparse_batch(pts[:n], ids=range(n))
    ix.build_index()
    space, data, chunk = ix.method.space, ix.method.data, ix.method._chunk
    xc = space.slice_data(data, 0, chunk)
    qenc = space.densify_queries(space.encode_queries(pts[n:]), xc, scan=True)
    post, qn = qenc["q_post"], qenc["qnorm"]
    errs = _sq_check_forms("dense table", qenc, xc)
    sl = [space.slice_data(data, s, chunk) for s in range(0, data.ids.shape[0], chunk)]
    e_all = int(data.length.sum())
    p_all = sum(_sq_products(post, x["cols"]) for x in sl)

    def scan(fn):
        return lambda: [fn("cosine", post, x["cols"], x["x"], qn, None, None, x["pad"]) for x in sl]

    with _PlainGuard.paused():
        one = _cuda_ms(lambda: S.qdense_dists("cosine", post, xc["cols"], xc["x"], qn, None, None, xc["pad"]), 20)
        full = _cuda_ms(scan(S.qdense_dists), 5)
        full_dev = _device_ms(scan(S.qdense_dists), "sparse_qdense")
        full_plain = _cuda_ms(scan(S.qdense_dists_reference), 1)
        table = S.postings_table(post)
    lens = data.length[:n].long()
    crow = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    real = (data.col[:n] >= 1) & (data.col[:n] < S.PAD_X)
    xs = torch.sparse_csr_tensor(crow, data.col[:n][real].long() - 1, data.val[:n][real], size=(n, post.v))
    lib = _cuda_ms(lambda: torch.sparse.mm(xs, table), 5)
    bound, by = _sq_bound_ms(e_all, p_all, int(post.ptr[-1]), nq, post.v, data.ids.shape[0])
    out = {"ms": one, "full_ms": full, "full_device_ms": full_dev, "full_plain_ms": full_plain, "library_ms": lib,
           "bound_ms": bound, "bound_by": by, "density": p_all / (e_all * nq), "max_abs_err": max(errs.values())}
    print(f"[sparse] kernel dense table: sparse_like(100512, vocab=1024, nnz=64), {data.ids.shape[0]} rows ({e_all} "
          f"elements) x {nq} queries, {p_all} non-zero products ({out['density']:.1%} of the pairs); every form "
          f"against its plain version (" + ", ".join(f"{c} {x:.3g}" for c, x in errs.items()) + " max |diff|); "
          f"cosine {one:.4f} ms a 4080-row launch (mean of 20); over the {len(sl)} launches {full:.3f} ms (mean of "
          f"5; device time {'not measured' if full_dev is None else f'{full_dev:.3f} ms'}), plain {full_plain:.3f} "
          f"ms, torch.sparse.mm of the dots alone {lib:.3f} ms, bound {bound:.3f} ms ({by}, "
          f"{bound / (full_dev or full):.1%}); {smi}", flush=True)
    return out


def _sq_edge_sweep() -> tuple:
    """csrc/sparse_qdense.cu against its plain version in every form at the edges: Q in {1, 7,
    130, 512, 4096} (130 and 7 leave a ragged 128-query tile, 4096 has 32 tiles), C in {1, 33,
    1000} (ragged 32-row groups), rows of at most 1, 64 and 200 slots (several 8-slot loads) with
    empty rows, zero-norm rows (real ids of value 0), rows holding a +inf, -inf or NaN value (NaN
    for every query that lacks its id), an empty query, query ids beyond the vocabulary and id 1 in
    every query (a run of every query of a tile), vocabularies of 128 and 1,024 ids, and the corpus
    arrays also 4 bytes off a 16-byte boundary (the kernel's scalar loads). Returns (runs, max
    |kernel - plain| over the finite cells of the non-integer forms)."""
    import torch
    from tpu_knn_torch.core.dataset import SparsePoint
    from tpu_knn_torch.ops import sparse as S
    from tpu_knn_torch.spaces.sparse import _pack_csr

    rng = np.random.default_rng(18)
    dev = torch.device("cuda")
    runs, worst = 0, 0.0

    def points(n, nnz, universe, empty_every, zero_every, nonfinite=False, first=False):
        pts = []
        for r in range(n):
            m = 0 if r % empty_every == 1 else (nnz if r % 2 else int(rng.integers(1, nnz + 1)))
            ids = np.sort(rng.choice(np.arange(1, universe + 1), size=min(m, universe), replace=False))
            if first and r % empty_every != 1 and (not ids.size or ids[0] != 1):
                ids = np.concatenate([[1], ids[:-1] if ids.size == m else ids])
            vals = rng.standard_normal(ids.size).astype(np.float32)
            if r % zero_every == 3:
                vals[:] = 0.0
            if nonfinite and ids.size and r % 17 == 5:
                vals[rng.integers(ids.size)] = (np.inf, -np.inf, np.nan)[r % 3]
            pts.append(SparsePoint(ids.astype(np.int32), vals))
        return pts

    def offset(t):  # the same values 4 bytes off a 16-byte boundary
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    with _PlainGuard.paused():
        for nnz in (1, 64, 200):
            for v in (128, 1024):
                xp = points(1000, nnz, v, 7, 11, nonfinite=True)
                xcol, xval, xlen = (torch.from_numpy(a).to(dev) for a in _pack_csr(xp, 1000))
                # the queries' ids run past the vocabulary (the postings drop them, as the scan does);
                # id 1 in every non-empty query
                qp = points(4096, min(nnz + 8, 80), v + 64, 9, 13, first=True)
                qcol, qval, qlen = (torch.from_numpy(a).to(dev) for a in _pack_csr(qp, 4096, pad_col=S.PAD_Q))
                pad = torch.zeros(1000, device=dev)
                pad[990:] = 1e30
                for nq in (1, 7, 130, 512, 4096):
                    for c in (1, 33, 1000):
                        for case, form, binary in SQ_CASES:
                            qv = (qval[:nq] != 0).float() if binary or form == "jaccard" else qval[:nq]
                            xv = (xval[:c] != 0).float() if binary else xval[:c]
                            post = S.postings(qcol[:nq], qv, v)
                            for off in (0, 1):
                                xc_, xv_ = (offset(xcol[:c]), offset(xv)) if off else (xcol[:c], xv)
                                args = (form, post, xc_, xv_, S.norms_from_vals(qv), qlen[:nq], xlen[:c], pad[:c])
                                err = _sq_compare(f"sparse kernel edge sweep {case} nnz={nnz} V={v} Q={nq} C={c} "
                                                  f"offset={off}", S.qdense_dists(*args),
                                                  S.qdense_dists_reference(*args), binary or form == "jaccard")
                                worst = max(worst, err)
                                runs += 1
    torch.cuda.synchronize()
    return runs, worst


def _phase_sparse(smi):
    """Phase 18: the sparse spaces over sparse_like bag-of-words corpora
    (the NMSLIB TF-IDF deployments, which the repository does not hold).
    (a) bench.py's config 5: cosinesimil_sparse over 100,000 rows of
    sparse_like(102_048, vocab=30_000, nnz=64, seed=0), 512 queries, k=10:
    the exact scan against a float64 scipy oracle and the sketchDim=0 HNSW
    build (M=16, efConstruction=100, waveSize=512); (b) the default build
    (sketch proxy, sketchDim=1024, exactBase, exactPairs) on the same rows;
    (c) the 1M exact scan (sparse_like(1_000_512, vocab=60_000, nnz=64));
    (d) 5,000-row side cells. Returns the numbers it printed."""
    import os
    import shutil
    import tempfile

    import torch
    from tpu_knn_torch import DataKind, Index, Params
    from tpu_knn_torch.eval.datasets import sparse_like
    from tpu_knn_torch.io import native
    from tpu_knn_torch.ops import graph as G
    from tpu_knn_torch.ops import groupmin as GM
    from tpu_knn_torch.ops import sparse as S
    from tpu_knn_torch.ops import topk as T

    out = {}
    zero = {"self_links": 0, "dup_links": 0, "oob_links": 0}
    n, nq, k, vocab = 100_000, 512, K, 30_000
    th = time.perf_counter()
    pts = sparse_like(n + 2048, vocab=vocab, nnz=64, seed=0)
    corpus, queries = pts[:n], pts[n:n + nq]
    x64, q64 = _csr64(corpus, vocab), _csr64(queries, vocab)
    print(f"[sparse] data: sparse_like({n + 2048}, vocab={vocab}, nnz=64, seed=0) in {time.perf_counter() - th:.2f} s, "
          f"{x64.nnz / n:.2f} distinct terms per row; native pack_csr {native.available()}", flush=True)

    # ---- (a) the exact scan ----
    t0 = time.perf_counter()
    d64, b64 = _sparse_f64("cosine", q64, x64)
    oracle_s = time.perf_counter() - t0
    ex = Index("cosinesimil_sparse", method="seq_search", data_type=DataKind.SPARSE, device="cuda")
    tb = time.perf_counter()
    ex.add_sparse_batch(corpus, ids=range(n))  # object ids = row positions of the oracle
    ex.build_index()
    torch.cuda.synchronize()
    scan_build = time.perf_counter() - tb
    torch.cuda.reset_peak_memory_stats()
    GM.reset_launches()
    med, de, ie = _timed_knn(ex, queries, k, 5, statistics.median)
    launches_a = GM.launches["sparse_qdense_cosine"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    diff, err = _check_sparse_knn("scan cosinesimil_sparse 100k", ie, de, d64, b64, k)
    out["scan_100k"] = {"qps": nq / med, "ms": med * 1e3, "peak_gib": peak, "launches": launches_a}
    print(f"[sparse] (a) scan cosinesimil_sparse {n} rows, {nq} queries, k={k}: encode {scan_build:.2f} s, median of 5 "
          f"{med * 1e3:.2f} ms, {nq / med:.0f} qps, peak allocated {peak:.3f} GiB; route {ex.method.last_route}; "
          f"sparse_qdense_cosine launched {launches_a} times in 6 scans of {ex.method.data.ids.shape[0]} rows "
          f"({ex.method._chunk}-row chunks); ids against the f64 scipy oracle ({oracle_s:.1f} s): {diff} differ on "
          f"ties, max |dist - f64| {err:.3g}; {smi}", flush=True)
    _require(launches_a == 6 * (ex.method.data.ids.shape[0] // ex.method._chunk) and sum(GM.launches.values()) == launches_a,
             lambda: f"(a): kernel launches {GM.launches}")
    _require(ex.method.last_route == "single", lambda: f"the sparse scan took the {ex.method.last_route} route")

    def hnsw_cell(label, params, ix=None):
        ix = ix or Index("cosinesimil_sparse", data_type=DataKind.SPARSE, device="cuda")
        ix.add_sparse_batch(corpus, ids=range(n))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tb = time.perf_counter()
        ix.build_index(Params(params))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - tb
        peak = torch.cuda.max_memory_allocated() / 2**30
        chk = ix.method.check_graph()
        rows = {}
        for ef in (50, 100):
            ix.set_query_time_params(Params(efSearch=ef))
            best, dh, ih = _timed_knn(ix, queries, k, 3, min)
            rows[ef] = {"recall": _recall_at(ih, ie, k), "qps": nq / best, "ms": best * 1e3}
            got64 = d64[np.arange(nq)[:, None], ih]
            exact = bool((ih >= 0).all() and np.all(np.abs(dh - got64) <= np.maximum(5e-3 * np.abs(got64) + 1e-5,
                                                                                      b64[np.arange(nq)[:, None], ih])))
            _require(exact, lambda: f"{label} efSearch={ef}: a distance off its id's f64 value")
        print(f"[sparse] {label} {n} rows, {params}: build {build_s:.2f} s, peak allocated {peak:.3f} GiB, "
              f"check_graph {chk}, " + ", ".join(
                  f"efSearch={ef} recall@{k} {r['recall']:.4f} best of 3 {r['ms']:.2f} ms {r['qps']:.0f} qps"
                  for ef, r in rows.items()) + f", distances exact; {smi}", flush=True)
        _require(chk == zero, lambda: f"{label}: check_graph {chk}")
        _require(rows[100]["recall"] >= 0.95, lambda: f"{label}: recall@10 at efSearch=100 {rows[100]['recall']}")
        return ix, {"build_s": build_s, "peak_gib": peak, "search": rows}

    G.reset_counters()
    hx, out["hnsw_default"] = hnsw_cell("(b) hnsw default (sketch proxy)", dict(M=16, efConstruction=100,
                                                                                waveSize=512))
    # ---- save/load of (b)'s index in each mode ----
    hx.set_query_time_params(Params(efSearch=100))
    d0, i0 = hx.knn_query_batch(queries, k)
    tmp = tempfile.mkdtemp(prefix="tk_sparse_")
    try:
        for save_data in (True, False):
            path = os.path.join(tmp, f"sp{int(save_data)}")
            hx.save(path, save_data=save_data)
            for load_data in (True, False):
                ld = Index.load(path, load_data=load_data, device="cuda")
                ld.set_query_time_params(Params(efSearch=100))
                d1, i1 = ld.knn_query_batch(queries, k)
                _require(np.array_equal(i0, i1) and np.array_equal(d0, d1),
                         lambda: f"sparse save_data={save_data} load_data={load_data}: results changed")
                del ld
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("[sparse] save/load of (b)'s index, save_data and load_data each True and False: results bit-identical",
          flush=True)
    del hx
    torch.cuda.empty_cache()

    # ---- (d) side cells at 5,000 rows (cut from 20,000 to keep the phase near 300 s, then from
    # 10,000: the whole script took 1292.7 s of command on a slow host, NVIDIA H100 80GB HBM3,
    # 700 W; the exact-wave build, sketchDim=0, moved here from 100,000 rows: its graph holds
    # tpu_knn's on the CPU) ----
    n2, nq2 = 5_000, 256
    c2, q2 = corpus[:n2], queries[:nq2]
    x2, qq2 = x64[:n2], q64[:nq2]
    oracles = {}
    t0 = time.perf_counter()
    for name, kind in SPARSE_NAMES.items():
        if kind not in oracles:
            oracles[kind] = _sparse_f64(kind, qq2, x2)
        dd, bb = oracles[kind]
        prm = Params(p=3.0) if name == "lp_sparse" else None
        ix = Index(name, prm, method="seq_search", data_type=DataKind.SPARSE, device="cuda")
        ix.add_sparse_batch(c2, ids=range(n2))
        dk, ik = ix.knn_query_batch(q2, k)
        diff, err = _check_sparse_knn(f"scan {name}", ik, dk, dd, bb, k)
        radius = float(np.median(np.sort(dd, axis=1)[:, k - 1]))
        hits, und = _check_sparse_range(f"range {name}", ix.range_query_batch(q2, radius), dd, bb, radius)
        print(f"[sparse] (d) {name} {n2} rows, {nq2} queries: kNN ids {diff} differ from the f64 oracle on ties, max "
              f"|dist - f64| {err:.3g}; range at {radius:.6g}: {hits} hits, in or out as the oracle says "
              f"({und} within the bound of the radius)", flush=True)
    out["names_s"] = time.perf_counter() - t0

    dd, bb = oracles["cosine"]
    gold = np.argsort(dd, axis=1, kind="stable")[:, :k]
    side = {}
    from tpu_knn_torch.utils import tracing

    # recall@10 floors at efSearch=100: sketch traversal is limited by the
    # sketch's noise; l2 over unnormalized bag-of-words rows is harder for
    # the graph (its exact-wave graph holds tpu_knn's neighbour sets on the
    # CPU, tests/test_torch_sparse.py, so its recall is tpu_knn's). The
    # exact-wave build also reads its wave phases' device seconds from the
    # tracer's hnsw.wave.* spans.
    for label, name, params, floor in (
            ("sketchDim=0", "cosinesimil_sparse", dict(sketchDim=0), 0.9),
            ("sketchQuery=1", "cosinesimil_sparse", dict(sketchQuery=1), 0.5),
            ("exactPost=1 exactShrink=1", "cosinesimil_sparse", dict(exactPost=1, exactShrink=1), 0.9),
            ("l2_sparse", "l2_sparse", {}, 0.85),
            ("sparse_jaccard", "sparse_jaccard", {}, 0.9)):
        ix = Index(name, data_type=DataKind.SPARSE, device="cuda")
        ix.add_sparse_batch(c2, ids=range(n2))
        if label == "sketchDim=0":
            tracing.reset()
            tracing.enable()
        try:
            tb = time.perf_counter()
            ix.build_index(Params(dict(M=16, efConstruction=100, waveSize=512, **params)))
            torch.cuda.synchronize()
            bs = time.perf_counter() - tb
            if label == "sketchDim=0":
                out["wave_profile"] = {"build_s": bs, **{
                    name[len("hnsw.wave."):]: (t["device_ms"] or 0.0) / 1e3
                    for name, t in tracing.totals().items() if name.startswith("hnsw.wave.")}}
                print(f"[sparse] (d) hnsw {label} {n2} rows, wave phases' device seconds: " + ", ".join(
                    f"{key} {v:.3f} s" for key, v in out["wave_profile"].items()) + f"; {smi}", flush=True)
        finally:
            tracing.disable()
        chk = ix.method.check_graph()
        ix.set_query_time_params(Params(efSearch=100))
        dh, ih = ix.knn_query_batch(q2, k)
        dn, bn = oracles[SPARSE_NAMES[name]]
        g = gold if name == "cosinesimil_sparse" else np.argsort(dn, axis=1, kind="stable")[:, :k]
        rec = _recall_at(ih, g, k)
        got64 = dn[np.arange(nq2)[:, None], ih]
        exact = bool((ih >= 0).all() and np.all(np.abs(dh - got64) <= np.maximum(
            5e-3 * np.abs(got64) + 1e-5, bn[np.arange(nq2)[:, None], ih])))
        side[label] = {"build_s": bs, "recall": rec}
        print(f"[sparse] (d) hnsw {label} {n2} rows: build {bs:.2f} s, check_graph {chk}, recall@{k} at efSearch=100 "
              f"{rec:.4f} against the f64 oracle, distances exact {exact}; {smi}", flush=True)
        _require(chk == zero and exact, lambda: f"hnsw {label}: check_graph {chk}, distances exact {exact}")
        _require(rec >= floor, lambda: f"hnsw {label}: recall {rec} below {floor}")
    out["side"] = side

    # ---- R drawn on the card against R drawn on the CPU ----
    v_pad = 30_080
    r_dev = S.sketch_matrix(v_pad, 1024, 0, "cuda").cpu().numpy()
    r_cpu = S.sketch_matrix(v_pad, 1024, 0, "cpu").numpy()
    ulp = int(np.abs(r_dev.view(np.int32).astype(np.int64) - r_cpu.view(np.int32)).max())
    ndiff = int(np.sum(r_dev != r_cpu))
    print(f"[sparse] R f32[{v_pad}, 1024] from seed 0 drawn on the card against the CPU: {ndiff} values differ, "
          f"max {ulp} ulp", flush=True)
    _require(ulp <= 2, lambda: f"R on the card differs from the CPU's by {ulp} ulp")
    out["r_ulp"] = ulp
    del r_dev, r_cpu

    # ---- (c) the 1M exact scan ----
    n3, vocab3 = 1_000_000, 60_000
    th = time.perf_counter()
    p3 = sparse_like(n3 + 512, vocab=vocab3, nnz=64, seed=0)
    c3, qq3 = p3[:n3], p3[n3:n3 + nq]
    data_s = time.perf_counter() - th
    big = Index("cosinesimil_sparse", method="seq_search", data_type=DataKind.SPARSE, device="cuda")
    tb = time.perf_counter()
    big.add_sparse_batch(c3, ids=range(n3))
    big.build_index()
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - tb

    # ---- the kernel, csrc/sparse_qdense.cu: every form against its plain version at (a)'s and
    # (c)'s chunk shapes and over (c)'s whole corpus, at a dense-table shape, then the edge sweep ----
    t0 = time.perf_counter()
    out["kernel"] = {"config5": _sq_cell(smi, "config 5", ex, queries, False),
                     "1m": _sq_cell(smi, "1M", big, qq3, True), "dense": _sq_dense_cell(smi)}
    runs, worst = _sq_edge_sweep()
    out["kernel"]["sweep"] = {"runs": runs, "max_abs_err": worst}
    print(f"[sparse] kernel edge sweep: {runs} runs (Q 1-4096, C 1-1000, rows of 1-200 slots, empty, zero-norm, "
          f"+-inf and NaN rows, out-of-vocabulary query ids, id 1 in every query, corpus arrays off a 16-byte "
          f"boundary) each equal to or within rtol 5e-3 of the plain version, NaN where it is, max |diff| "
          f"{worst:.3g}; the kernel step {time.perf_counter() - t0:.1f} s", flush=True)
    del ex

    # ---- (c) the main path: the 1M scan, every count set to 0 just before it ----
    torch.cuda.reset_peak_memory_stats()
    GM.reset_launches()
    med3, d3, i3 = _timed_knn(big, qq3, k, 5, statistics.median)
    launches3 = dict(GM.launches)
    peak3 = torch.cuda.max_memory_allocated() / 2**30
    chunks3 = big.method.data.ids.shape[0] // big.method._chunk
    _require(launches3["sparse_qdense_cosine"] == 6 * chunks3 and sum(launches3.values()) == 6 * chunks3,
             lambda: f"(c): kernel launches {launches3}, {6 * chunks3} expected")
    # the wall's split: the kernel's launches of one scan (above) and its top-k merges, each by CUDA
    # events; the rest is the postings, the host's launches and the final copy
    blk = torch.rand((nq, big.method._chunk), device="cuda")
    fd = torch.full((nq, k), float("inf"), device="cuda")
    fi = torch.full((nq, k), -1, dtype=torch.int64, device="cuda")
    cols = torch.arange(big.method._chunk, device="cuda").expand(nq, -1)
    merge_ms = _cuda_ms(lambda: [T.merge_topk(fd, fi, blk, cols, k) for _ in range(chunks3)], 3)
    kern_ms = out["kernel"]["1m"]["full_device_ms"] or out["kernel"]["1m"]["full_ms"]
    del blk, fd, fi, cols
    t0 = time.perf_counter()
    o3, ob3 = _sparse_f64("cosine", _csr64(qq3[:64], vocab3), _csr64(c3, vocab3))
    diff3, err3 = _check_sparse_knn("scan cosinesimil_sparse 1M", i3[:64], d3[:64], o3, ob3, k)
    oracle_s = time.perf_counter() - t0
    # the least time for the scan's work: the corpus elements (id and value)
    # and the query records read once, the top-k written once, against one
    # multiply-add a non-zero product (an element and a query holding its id)
    # at the FP32 peak
    lens = np.fromiter((len(p[0]) for p in c3), np.int64, n3)
    nnz3 = int(lens.sum())
    k1m = out["kernel"]["1m"]
    bound_ms = max((8 * nnz3 + 8 * k1m["records"] + 8 * nq * k) / 3.35e12, 2 * k1m["full_products"] / 67e12) * 1e3
    # the library call for the dots alone: cuSPARSE's CSR times dense
    crow = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])).cuda()
    xcol = torch.from_numpy(np.concatenate([p[0] for p in c3]).astype(np.int64) - 1).cuda()
    xval = torch.from_numpy(np.concatenate([p[1] for p in c3])).cuda()
    xs = torch.sparse_csr_tensor(crow, xcol, xval, size=(n3, vocab3))
    qt = torch.from_numpy(_csr64(qq3, vocab3).toarray().T.astype(np.float32)).cuda().contiguous()
    lib_ms = _cuda_ms(lambda: torch.sparse.mm(xs, qt), 5)
    del xs, qt, crow, xcol, xval
    out["scan_1m"] = {"qps": nq / med3, "ms": med3 * 1e3, "peak_gib": peak3, "bound_ms": bound_ms,
                      "library_ms": lib_ms, "launches": launches3["sparse_qdense_cosine"], "kernel_ms": kern_ms,
                      "merge_ms": merge_ms}
    print(f"[sparse] (c) scan cosinesimil_sparse {n3} rows (vocab {vocab3}, {nnz3} elements), {nq} queries: data "
          f"{data_s:.1f} s, add + encode {enc_s:.1f} s, median of 5 {med3 * 1e3:.2f} ms, {nq / med3:.0f} qps, peak "
          f"allocated {peak3:.3f} GiB; sparse_qdense_cosine launched {launches3['sparse_qdense_cosine']} times in 6 "
          f"scans ({chunks3} chunks of {big.method._chunk} rows each), no other kernel; of the wall the kernel "
          f"{kern_ms:.3f} ms and the {chunks3} top-k merges {merge_ms:.3f} ms (CUDA events), the rest "
          f"{med3 * 1e3 - kern_ms - merge_ms:.3f} ms (the postings, the host's launches, the copy back); bound "
          f"{bound_ms:.3f} ms; library torch.sparse.mm of the dots alone {lib_ms:.3f} ms (CUDA events, mean of 5); "
          f"64 queries against the f64 oracle ({oracle_s:.1f} s): {diff3} ids differ on ties, max |dist - f64| "
          f"{err3:.3g}; {smi}", flush=True)
    return out


# ---------------- phase 19: bits, word_embed, NAPP and the inverted index ----------------


def _popcount32(v):
    """Set bits of each 32-bit word of an int tensor (SWAR, in int64)."""
    import torch

    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _unpack_words(w):
    """0/1 float64 rows [n, 32 * words] of packed words int32 [n, words] on
    the card (bit j of word i = element 32i+j), for the oracle."""
    import torch

    shifts = torch.arange(32, device=w.device, dtype=torch.int64)
    return ((w.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(w.shape[0], -1).double()


def _bit_oracle(qw, xw, k: int, chunk: int = 65536):
    """The k smallest exact Hamming distances (int64 [Q, k], ascending) and
    the k smallest Jaccard distances in float64 ([Q, k]) of the packed
    queries ``qw`` to the packed rows ``xw``: hamming = popcount(q) +
    popcount(x) - 2 popcount(q AND x), popcount(q AND x) an exact integer
    product of the 0/1 rows in float64 (sums <= 256)."""
    import torch

    pq = _popcount32(qw).sum(1).double()
    qb = _unpack_words(qw)
    hs, js = [], []
    for c0 in range(0, xw.shape[0], chunk):
        xc = xw[c0:c0 + chunk]
        inter = qb @ _unpack_words(xc).T
        px = _popcount32(xc).sum(1).double()
        union = pq[:, None] + px[None, :] - inter
        ham = union - inter
        jac = torch.where(union > 0, 1.0 - inter / torch.clamp_min(union, 1.0), 0.0)
        hs.append(torch.topk(ham, k, dim=1, largest=False).values)
        js.append(torch.topk(jac, k, dim=1, largest=False).values)
    ham = torch.topk(torch.cat(hs, 1), k, dim=1, largest=False).values
    jac = torch.topk(torch.cat(js, 1), k, dim=1, largest=False).values
    return ham.round().long().cpu().numpy(), jac.cpu().numpy()


def _same_after_save_load(label, idx, pts, k: int, query_params=None):
    """Save ``idx`` with save_data True and False, load each on the card
    and require knn_query_batch results bit-identical to the index's."""
    import os
    import shutil
    import tempfile

    from tpu_knn_torch import Index

    d0, i0 = idx.knn_query_batch(pts, k)
    tmp = tempfile.mkdtemp(prefix="tk_p19_")
    try:
        for save_data in (True, False):
            path = os.path.join(tmp, f"ix{int(save_data)}")
            idx.save(path, save_data=save_data)
            ld = Index.load(path, device="cuda")
            if query_params is not None:
                ld.set_query_time_params(query_params)
            d1, i1 = ld.knn_query_batch(pts, k)
            _require(np.array_equal(d0, d1) and np.array_equal(i0, i1),
                     lambda: f"{label}: results changed after save_data={save_data} and load")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[save/load] {label}: save_data True and False, loaded on the card: results bit-identical", flush=True)


def _phase_bits(smi, corpus, queries):
    """(a) SimHash codes of phase 4's rows: bit_hamming (two-pass, the f32
    group-min kernel on the 0/1 rows) and bit_jaccard (block route) over
    1,000,000 codes of 256 bits, 2048 queries, k=10, against exact integer
    and float64 oracles. Returns the numbers it printed."""
    import torch
    from tpu_knn_torch import Index
    from tpu_knn_torch.methods import seq_search as SS
    from tpu_knn_torch.ops import groupmin as GM
    from tpu_knn_torch.spaces.bits import unpack_bit_vectors

    out = {}
    nq, k = queries.shape[0], K
    th = time.perf_counter()
    proj = np.random.default_rng(0).standard_normal((DIM, 256)).astype(np.float32)

    def simhash(x):  # bit j of word i = element 32i+j
        return np.packbits((x @ proj) > 0, axis=1, bitorder="little").view("<u4")

    wc, wq = simhash(corpus), simhash(queries)
    qbits = unpack_bit_vectors(wq)
    xw = torch.from_numpy(wc.view(np.int32)).cuda()
    qw = torch.from_numpy(wq.view(np.int32)).cuda()
    t_or = time.perf_counter()
    ham_k, jac_k = _bit_oracle(qw, xw, k)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t_or
    print(f"[bits] data: SimHash of sift_like rows by a seeded [128, 256] Gaussian projection, {wc.shape[0]} codes of "
          f"256 bits ({wc.shape[1]} uint32 words a row), {nq} queries, in {t_or - th:.2f} s; oracle {oracle_s:.2f} s",
          flush=True)

    ix = Index("bit_hamming", method="seq_search", data_type="dense_uint8_vector", dist_type="int", device="cuda")
    tb = time.perf_counter()
    ix.add_bit_batch_packed(wc)
    ix.build_index()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    GM.reset_launches()
    d, i = ix.knn_query_batch(qbits, k)
    launched = dict(GM.launches)
    route = ix.method.last_route
    _require(route == "twopass" and launched["float32"] > 0 and ix.method.data.vecs.dtype == torch.float32
             and launched["int8"] == 0, lambda: f"bit_hamming: route {route}, launches {launched}")
    med, d, i = _timed_knn(ix, qbits, k, 5, statistics.median)
    stages, qenc = _breakdown(ix, qbits, k)
    # exactness: the returned distances are the k smallest exact ones, and
    # each returned id's popcount(q XOR x) is its returned distance
    _require(np.array_equal(d.astype(np.int64), ham_k),
             lambda: f"bit_hamming: {int((d.astype(np.int64) != ham_k).sum())} distances off the popcount oracle")
    pos = torch.from_numpy(i.astype(np.int64)).cuda()
    xor = _popcount32(torch.bitwise_xor(qw[:, None, :], xw[pos])).sum(2).cpu().numpy()
    _require(bool((i >= 0).all()) and np.array_equal(xor, d.astype(np.int64)),
             lambda: "bit_hamming: a returned id's popcount(q XOR x) is not its distance")
    # the kernel at D=256 against its plain version on the same inputs
    data = ix.method.data
    q, qt, xt, scale = SS._kernel_inputs(ix.space, qenc, data)
    mins = GM.fused_groupmin(q, data.vecs, qt, xt, scale)
    ref = GM.fused_groupmin_reference(q, data.vecs, qt, xt, scale)
    kerr = float((mins - ref).abs().max())
    _require(kerr == 0.0, lambda: f"groupmin_f32 on 0/1 rows: max |kernel - plain| {kerr} (integers expected)")
    kms = _cuda_ms(lambda: GM.fused_groupmin(q, data.vecs, qt, xt, scale), 5)
    pms = _cuda_ms(lambda: GM.fused_groupmin_reference(q, data.vecs, qt, xt, scale), 2)
    bms, bby = _bound_ms("float32", q, data.vecs)
    out["hamming"] = {"ms": med * 1e3, "qps": nq / med, "build_s": build_s, "launches": launched["float32"],
                      "kernel_ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": bby, "stages_ms": stages}
    print(f"[bits] (a) bit_hamming {data.count} rows x {data.vecs.shape[1]} columns, {nq} queries, k={k}: add + "
          f"encode {build_s:.2f} s, route {route}, median of 5 {med * 1e3:.3f} ms ({nq / med:.0f} qps); stages "
          f"(CUDA events, mean of 5) " + ", ".join(f"{s} {v:.3f} ms" for s, v in stages.items())
          + f"; groupmin_f32 launches {launched['float32']} (other tiers {launched['int8']}/{launched['high']}/"
          f"{launched['bfloat16']}); kernel {kms:.3f} ms against plain {pms:.3f} ms, bound {bms:.3f} ms ({bby}), "
          f"share {bms / kms:.1%}, max |kernel - plain| {kerr}; distances equal to the popcount oracle, every id's "
          f"popcount(q XOR x) its distance; {smi}", flush=True)
    del ix, data, q, qenc
    torch.cuda.empty_cache()

    jx = Index("bit_jaccard", method="seq_search", data_type="dense_uint8_vector", dist_type="float", device="cuda")
    tb = time.perf_counter()
    jx.add_bit_batch_packed(wc)
    jx.build_index()
    torch.cuda.synchronize()
    jbuild = time.perf_counter() - tb
    GM.reset_launches()
    medj, dj, ij = _timed_knn(jx, qbits, k, 3, statistics.median)
    jl = sum(GM.launches.values())
    _require(jx.method.last_route == "twopass" and jl == 0,
             lambda: f"bit_jaccard: route {jx.method.last_route}, group-min launches {jl} (no affine form)")
    # each returned id's f64 Jaccard distance, and the f32 bound of 1 - a/b
    pos = torch.from_numpy(ij.astype(np.int64)).cuda()
    qb, xb = _unpack_words(qw), _unpack_words(xw[pos.reshape(-1)]).reshape(nq, k, -1)
    inter = torch.einsum("qd,qkd->qk", qb, xb)
    union = qb.sum(1)[:, None] + xb.sum(2) - inter
    got64 = torch.where(union > 0, 1.0 - inter / torch.clamp_min(union, 1.0), 0.0).cpu().numpy()
    bound = 4 * U
    derr = float(np.abs(dj - got64).max())
    _require(derr <= bound, lambda: f"bit_jaccard: a distance off its id's f64 value by {derr}")
    tie_err = float(np.abs(np.sort(got64, 1) - jac_k).max())
    _require(tie_err <= 2 * bound, lambda: f"bit_jaccard: ids not a top-{k} of the f64 oracle ({tie_err})")
    out["jaccard"] = {"ms": medj * 1e3, "qps": nq / medj, "build_s": jbuild}
    print(f"[bits] (a) bit_jaccard same codes: add + encode {jbuild:.2f} s, route {jx.method.last_route} (block "
          f"scan, no kernel launch), median of 3 {medj * 1e3:.3f} ms ({nq / medj:.0f} qps); max |dist - f64| "
          f"{derr:.3g}, the returned ids a top-{k} of the f64 oracle up to ties within 2x the f32 bound; {smi}",
          flush=True)
    del jx
    for name, dt in (("bit_hamming", "int"), ("bit_jaccard", "float")):
        sx = Index(name, method="seq_search", data_type="dense_uint8_vector", dist_type=dt, device="cuda")
        sx.add_bit_batch_packed(wc[:20_000])
        _same_after_save_load(f"(a) {name} over 20,000 codes", sx, qbits[:256], k)
    return out


def _phase_embed(smi):
    """(b) word_embed over 20,000 glove_like(20_256, 100, seed=0) rows
    written as "w<i> v1 ... v100" lines (%.9g), 256 queries as bare words
    of the preloaded file: dist=l2 and dist=cosine on seq_search and on
    HNSW, equal to Index("l2") / Index("cosinesimil") over the parsed
    vectors, and after save/load of the string store. Returns the numbers
    it printed."""
    import os
    import shutil
    import tempfile

    import torch
    from tpu_knn_torch import Index, Params
    from tpu_knn_torch.eval.datasets import glove_like
    from tpu_knn_torch.spaces.embed import parse_embed_line

    n, nq, k = 20_000, 256, K
    g = glove_like(n + nq, 100, seed=0)
    lines = [f"w{r} " + " ".join("%.9g" % v for v in row) for r, row in enumerate(g)]
    vecs = np.stack([parse_embed_line(ln)[1] for ln in lines])
    _require(np.array_equal(vecs, g), lambda: "%.9g lines do not parse back to the same f32 vectors")
    words = [f"w{r}" for r in range(n, n + nq)]
    build = Params(M=16, efConstruction=100, waveSize=1024)
    out = {}
    tmp = tempfile.mkdtemp(prefix="tk_embed_")
    try:
        path = os.path.join(tmp, "glove.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        for dist, inner in (("l2", "l2"), ("cosine", "cosinesimil")):
            for method in ("seq_search", "hnsw"):
                tb = time.perf_counter()
                we = Index("word_embed", Params(dist=dist, file=path), method=method, data_type="object_as_string",
                           device="cuda")
                we.add_string_batch(lines[:n])
                we.build_index(build if method == "hnsw" else None)
                torch.cuda.synchronize()
                bs = time.perf_counter() - tb
                pl = Index(inner, Params(dim=100), method=method, device="cuda")
                pl.add_dense_batch(vecs[:n])
                pl.build_index(build if method == "hnsw" else None)
                if method == "hnsw":
                    same_graph = torch.equal(we.method.graph["level0"], pl.method.graph["level0"])
                    _require(same_graph, lambda: f"word_embed {dist} hnsw: level 0 differs from {inner}'s")
                    for ix in (we, pl):
                        ix.set_query_time_params(Params(efSearch=100))
                d1, i1 = we.knn_query_batch(words, k)
                d2, i2 = pl.knn_query_batch(vecs[n:], k)
                _require(np.array_equal(d1, d2) and np.array_equal(i1, i2),
                         lambda: f"word_embed {dist} {method}: results differ from {inner} over the parsed vectors")
                sp = os.path.join(tmp, f"{dist}_{method}")
                we.save(sp)
                ld = Index.load(sp, device="cuda")
                if method == "hnsw":
                    ld.set_query_time_params(Params(efSearch=100))
                d3, i3 = ld.knn_query_batch(words, k)
                _require(np.array_equal(d1, d3) and np.array_equal(i1, i3) and ld.borrow_data_point_string(7) == lines[7],
                         lambda: f"word_embed {dist} {method}: results changed after save/load")
                out[f"{dist}_{method}"] = {"build_s": bs}
                print(f"[embed] (b) word_embed dist={dist} {method} {n} lines, {nq} bare-word queries: add + build "
                      f"{bs:.2f} s; results equal to {inner} over the parsed vectors"
                      + (" (level 0 equal)" if method == "hnsw" else "")
                      + f", and after save/load of the string store; {smi}", flush=True)
                del we, pl, ld
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _phase_napp(smi, corpus, queries, i10):
    """(c) NAPP on bench.py's config 5 (the 100,000 sparse_like rows and 512
    queries of phase 18 (a), cosinesimil_sparse), numPivot=512,
    numPrefix=32, minTimes 2-4 on both invProcAlg routes; (d) NAPP over
    phase 4's 1,000,000 rows (l2, minTimes=2, 2048 queries) against phase
    4's exact ids, and at 20,000 rows a range query with every row a
    candidate against seq_search's. Returns the numbers it printed."""
    import torch
    from tpu_knn_torch import DataKind, Index, Params
    from tpu_knn_torch.eval.datasets import sparse_like

    out = {"config5": {}}
    k = K
    n, nq = 100_000, 512
    pts = sparse_like(n + 2048, vocab=30_000, nnz=64, seed=0)
    c5, q5 = pts[:n], pts[n:n + nq]
    ex = Index("cosinesimil_sparse", method="seq_search", data_type=DataKind.SPARSE, device="cuda")
    ex.add_sparse_batch(c5, ids=range(n))
    _, gold = ex.knn_query_batch(q5, k)
    del ex
    nx = Index("cosinesimil_sparse", method="napp", data_type=DataKind.SPARSE, device="cuda")
    nx.add_sparse_batch(c5, ids=range(n))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tb = time.perf_counter()
    nx.build_index(Params(numPivot=512, numPrefix=32))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[napp] (c) cosinesimil_sparse {n} rows (config 5), numPivot=512 numPrefix=32: build {build_s:.2f} s, "
          f"peak allocated {peak:.3f} GiB, chunk {nx.method._chunk} (scan chunk {nx.method._scan_chunk}); {smi}",
          flush=True)
    out["config5"]["build_s"], out["config5"]["peak_gib"] = build_s, peak
    for mt in (2, 3, 4):
        for alg in ("scan", "gather"):
            nx.set_query_time_params(Params(minTimes=mt, invProcAlg=alg))
            nx.method.dist_comps = 0
            _, ig = nx.knn_query_batch(q5, k)
            dc = nx.method.dist_comps / nq
            med, _, ig = _timed_knn(nx, q5, k, 3, statistics.median)
            rec = _recall_at(ig, gold, k)
            out["config5"][f"{alg}_{mt}"] = {"recall": rec, "qps": nq / med, "dist_comps": dc}
            print(f"[napp] (c) minTimes={mt} invProcAlg={alg}: recall@{k} {rec:.4f} against the exact scan, median "
                  f"of 3 {med * 1e3:.2f} ms ({nq / med:.0f} qps), dist_comps {dc:.1f} a query; {smi}", flush=True)
    rec2 = out["config5"]["scan_2"]["recall"]
    _require(rec2 >= 0.95, lambda: f"napp config 5: recall@10 {rec2} at minTimes=2 (scan) below 0.95")
    gather = Params(minTimes=2, invProcAlg="gather")
    nx.set_query_time_params(gather)
    _same_after_save_load("(c) napp config 5, the gather route", nx, q5, k, gather)
    del nx, pts, c5, q5
    torch.cuda.empty_cache()

    # ---- (d) 1M dense rows ----
    nqd = queries.shape[0]
    dx = Index("l2", Params(dim=DIM), method="napp", device="cuda")
    dx.add_dense_batch(corpus)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tb = time.perf_counter()
    dx.build_index(Params(numPivot=512, numPrefix=32))
    torch.cuda.synchronize()
    dbuild = time.perf_counter() - tb
    dpeak = torch.cuda.max_memory_allocated() / 2**30
    dx.set_query_time_params(Params(minTimes=2))
    dx.method.dist_comps = 0
    dx.knn_query_batch(queries, k)
    ddc = dx.method.dist_comps / nqd
    med, dd, idd = _timed_knn(dx, queries, k, 3, statistics.median)
    rec = _recall_at(idd, i10, k)
    out["dense_1m"] = {"build_s": dbuild, "peak_gib": dpeak, "recall": rec, "qps": nqd / med, "dist_comps": ddc}
    print(f"[napp] (d) l2 {corpus.shape[0]} rows, numPivot=512 numPrefix=32 minTimes=2, {nqd} queries: build "
          f"{dbuild:.2f} s, peak allocated {dpeak:.3f} GiB, median of 3 {med * 1e3:.2f} ms ({nqd / med:.0f} qps), "
          f"recall@{k} {rec:.4f} against phase 4's exact ids, dist_comps {ddc:.0f} a query; {smi}", flush=True)
    _require(rec >= 0.95, lambda: f"napp 1M: recall@10 {rec} below 0.95")
    del dx
    torch.cuda.empty_cache()

    # ---- (d) range with every row a candidate equals the exact range ----
    n2, nq2 = 20_000, 256
    rx = Index("l2", Params(dim=DIM), method="napp", device="cuda")
    rx.add_dense_batch(corpus[:n2])
    rx.build_index(Params(numPivot=32, numPrefix=32))
    rx.set_query_time_params(Params(numPrefixSearch=32, minTimes=1))
    sx = Index("l2", Params(dim=DIM), method="seq_search", device="cuda")
    sx.add_dense_batch(corpus[:n2])
    d2, _ = sx.knn_query_batch(queries[:nq2], k)
    radius = float(np.median(d2[:, -1]))
    got, want = rx.range_query_batch(queries[:nq2], radius), sx.range_query_batch(queries[:nq2], radius)
    same = all(set(a.ids) == set(b.ids) for a, b in zip(got, want))
    hits = sum(len(b.ids) for b in want)
    _require(same, lambda: "napp range with every row a candidate differs from seq_search's")
    print(f"[napp] (d) range {n2} rows, numPivot = numPrefix = numPrefixSearch = 32, minTimes=1, {nq2} queries at "
          f"radius {radius:.6g}: {hits} hits, id sets equal to seq_search's for every query", flush=True)
    rx.set_query_time_params(None)
    _same_after_save_load(f"(d) napp l2 over {n2} rows", rx, queries[:nq2], k)
    out["range_hits"] = hits
    return out


def _phase_invindx(smi):
    """(e) simple_invindx over phase 18 (c)'s 1,000,000 sparse_like rows
    (vocab 60,000) under negdotprod_sparse_fast: batches of 1, 32 and 512
    queries at k=10 against the exact scan of the same space, determinism
    and batch independence. Returns the numbers it printed."""
    import torch
    from tpu_knn_torch import DataKind, Index
    from tpu_knn_torch.eval.datasets import sparse_like

    out = {}
    k, n3 = K, 1_000_000
    th = time.perf_counter()
    p3 = sparse_like(n3 + 512, vocab=60_000, nnz=64, seed=0)
    c3, q3 = p3[:n3], p3[n3:n3 + 512]
    data_s = time.perf_counter() - th
    tx = Index("negdotprod_sparse_fast", method="simple_invindx", data_type=DataKind.SPARSE, device="cuda")
    tb = time.perf_counter()
    tx.add_sparse_batch(c3, ids=range(n3))
    tx.build_index()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    inv = tx.method._inv
    # the exact scan of the same space over the same (validated) points
    ex = Index("negdotprod_sparse_fast", method="seq_search", data_type=DataKind.SPARSE, device="cuda")
    ex.store = tx.store
    ex.build_index()
    print(f"[invindx] (e) negdotprod_sparse_fast {n3} rows (vocab 60,000): data {data_s:.1f} s, add + postings "
          f"{build_s:.1f} s, {inv.total_postings} postings in {inv.pdoc_blocks.shape[0] - 1} blocks of 128", flush=True)
    for nq in (1, 32, 512):
        qs = q3[:nq]
        tx.method.dist_comps = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        d, i = tx.knn_query_batch(qs, k)
        peak = torch.cuda.max_memory_allocated() / 2**30
        touched = tx.method.dist_comps / max(8, nq)  # the batch runs bucketed to a power of two >= 8
        med, d2, i2 = _timed_knn(tx, qs, k, 5, statistics.median)
        _require(np.array_equal(d, d2) and np.array_equal(i, i2), lambda: f"taat nq={nq}: two calls differ")
        dr, ir = tx.knn_query_batch(qs[::-1], k)
        _require(np.array_equal(dr[::-1], d) and np.array_equal(ir[::-1], i),
                 lambda: f"taat nq={nq}: a reversed batch changed a query's bits")
        de, ie = ex.knn_query_batch(qs, k)
        _require(bool(np.isfinite(d).all() and (i >= 0).all()), lambda: f"taat nq={nq}: an untouched result")
        off = 0
        for r, c in zip(*np.nonzero(i != ie)):
            off += 1
            _require(i[r, c] in set(ie[r]) or bool(np.isclose(d[r, c], de[r, -1], rtol=5e-3, atol=1e-5)),
                     lambda: f"taat nq={nq}: query {r} returns id {i[r, c]} where the scan returns {ie[r, c]}")
        derr = float(np.max(np.abs(d - de) / np.maximum(np.abs(de), 1e-30)))
        _require(derr <= 5e-3, lambda: f"taat nq={nq}: distances off the exact scan's by {derr:.3g} relative")
        out[str(nq)] = {"ms": med * 1e3, "touched": touched, "peak_gib": peak}
        print(f"[invindx] (e) taat nq={nq}, k={k}: median of 5 {med * 1e3:.3f} ms a batch, {touched:.0f} touched "
              f"documents a query, peak allocated {peak:.3f} GiB; ids equal to the exact scan's except {off} on ties, "
              f"max relative |dist - scan| {derr:.3g}; two calls equal, a reversed batch the same bits; {smi}",
              flush=True)
    del tx, ex
    sm = Index("negdotprod_sparse_fast", method="simple_invindx", data_type=DataKind.SPARSE, device="cuda")
    sm.add_sparse_batch(c3[:100_000])
    _same_after_save_load("(e) simple_invindx over 100,000 rows", sm, q3[:32], k)
    return out


# ---------------- phase 20: VP-tree, sw-graph, the string spaces, SQFD, fusion, dummy ----------------


def _tie_recall(d, d_gold, k: int, rtol: float = 0.0) -> float:
    """Tie-aware recall@k: a returned id counts when its distance is at most
    the true k-th distance (integer distances tie in bulk), or ``rtol`` of it
    above (two kernels that sum in different orders round apart)."""
    kth = d_gold[:, k - 1:k] * (1.0 + rtol)
    return float(np.mean(np.sum(np.isfinite(d[:, :k]) & (d[:, :k] <= kth), axis=1) / k))


def _phase_vptree(smi, corpus, queries, i10, d10):
    """(a) [vptree]: VP-tree over phase 4's 1,000,000 sift_like rows (l2,
    bucketSize=64, seed 0; 2048 queries, k=10), tpu_knn's own 1M VP-tree
    cell: build seconds and peak; alpha=2 at maxLeavesToVisit 16/32/64 on
    the gathered route against phase 4's exact ids, qps (median of 3); the
    exact pruner on the masked route (256 queries); range at phase 9's
    radius against seq_search's. Returns the numbers it printed."""
    import torch
    from tpu_knn_torch import Index, Params

    n, nq, k = corpus.shape[0], queries.shape[0], K
    out = {}
    vp = Index("l2", Params(dim=DIM), method="vptree", device="cuda")
    vp.add_dense_batch(corpus)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tb = time.perf_counter()
    vp.build_index(Params(bucketSize=64, seed=0))
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - tb
    out["build_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    m = vp.method
    print(f"[vptree] build {n} x {DIM}, bucketSize=64: {out['build_s']:.2f} s, peak allocated "
          f"{out['build_peak_gib']:.3f} GiB, depth {m.depth}, leaf_cap {m.leaf_cap}, chunk {m._chunk}; {smi}",
          flush=True)
    q_dev = torch.from_numpy(queries).to("cuda")
    x_dev = torch.from_numpy(corpus).to("cuda")
    rows = {}
    for ml in (16, 32, 64):
        vp.set_query_time_params(Params(alphaLeft=2.0, alphaRight=2.0, maxLeavesToVisit=ml))
        m.dist_comps = 0
        torch.cuda.reset_peak_memory_stats()
        d, i = vp.knn_query_batch(queries, k)
        peak = torch.cuda.max_memory_allocated() / 2**30
        dc = m.dist_comps / nq
        med = _median_ms(lambda: vp.knn_query_batch(queries, k), reps=3)[0]
        err = _check_exact_distances(f"vptree maxLeavesToVisit={ml}", d, i, q_dev, x_dev)
        rows[ml] = {"recall": _recall_at(i, i10, k), "ms": med, "qps": nq / med * 1e3, "dist_comps": dc}
        print(f"[vptree] alpha=2 maxLeavesToVisit={ml} (gathered route): recall@{k} {rows[ml]['recall']:.4f} "
              f"against phase 4's exact ids, median of 3 {med:.2f} ms, {rows[ml]['qps']:.0f} qps, "
              f"{dc:.0f} distances a query, peak {peak:.3f} GiB; max |d - f64| {err:.3g}; {smi}", flush=True)
    recs = [rows[ml]["recall"] for ml in (16, 32, 64)]
    _require(recs[2] >= 0.95, lambda: f"vptree recall@10 {recs[2]} at alpha=2, maxLeavesToVisit=64")
    _require(recs[0] <= recs[1] <= recs[2], lambda: f"vptree recall falls as maxLeavesToVisit grows: {recs}")
    out["search"] = rows

    # the exact pruner (alpha=1, exp=1, no cap): the masked route
    nx = 256
    vp.set_query_time_params(None)
    tx = time.perf_counter()
    dx, ix = vp.knn_query_batch(queries[:nx], k)
    exact_s = time.perf_counter() - tx
    diff = ix != i10[:nx]
    tie = np.abs(dx - d10[:nx]) <= 1e-5 + 5e-3 * np.abs(d10[:nx])
    _require(not (diff & ~tie).any(), lambda: f"vptree exact pruner: {int((diff & ~tie).sum())} ids differ beyond ties")
    _check_exact_distances("vptree exact pruner", dx, ix, q_dev[:nx], x_dev)
    print(f"[vptree] exact pruner (masked route), {nx} queries: {exact_s * 1e3:.1f} ms, ids equal to phase 4's at "
          f"{int((~diff).sum())}/{diff.size} slots, the rest at equal distances; {smi}", flush=True)
    out["exact_masked_ms"] = exact_s * 1e3

    # range at phase 9's radius against seq_search's
    radius = float(np.median(d10[:, k - 1]))
    ss = Index("l2", Params(dim=DIM), method="seq_search", device="cuda")
    ss.add_dense_batch(corpus)
    want = ss.range_query_batch(queries[:nx], radius)
    del ss
    tr = time.perf_counter()
    got = vp.range_query_batch(queries[:nx], radius)
    range_s = time.perf_counter() - tr
    odd = 0
    for r, (g, w) in enumerate(zip(got, want)):
        sym = set(g.ids.tolist()) ^ set(w.ids.tolist())
        for pid in sym:  # only a pivot's distance, scored in another block, may cross the radius by an ulp
            dd = float(torch.linalg.vector_norm(x_dev[pid].double() - q_dev[r].double()))
            _require(abs(dd - radius) <= 1e-5 * radius, lambda: f"vptree range query {r}: id {pid} at {dd} differs")
        odd += len(sym)
    hits = sum(len(g) for g in got)
    print(f"[vptree] range at {radius:.4f}, {nx} queries: {range_s * 1e3:.1f} ms, {hits} hits, id sets equal to "
          f"seq_search's ({odd} differ within an ulp of the radius); {smi}", flush=True)
    out["range_ms"] = range_s * 1e3
    del vp, m, x_dev, q_dev
    torch.cuda.empty_cache()
    return out


def _phase_swgraph(smi):
    """(b) [swgraph]: sw-graph over HNSW-100k's rows (sift_like(102_048,
    128, seed=0)): built over the first 97,952 corpus rows, the last 2,048
    added after the build (a corpus that grows), 1,000 seeded deletions
    with neighbors_only and 1,000 with none, recall@10 against seq_search
    over the surviving rows and qps at efSearch 20/50/100, save/load with
    the mask. Returns the numbers it printed."""
    import os
    import shutil
    import tempfile

    import torch
    from tpu_knn_torch import Index, Params
    from tpu_knn_torch.eval.datasets import sift_like

    n, nq, k = 100_000, N_QUERIES, K
    xall = sift_like(n + nq, DIM, seed=0)
    corpus, queries = xall[:n], xall[n:]
    n0 = n - 2048
    zero = {"self_links": 0, "dup_links": 0, "oob_links": 0}
    out = {}
    sw = Index("l2", Params(dim=DIM), method="sw-graph", device="cuda")
    sw.add_dense_batch(corpus[:n0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tb = time.perf_counter()
    sw.build_index(Params(NN=16, efConstruction=100, waveSize=1024))
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - tb
    out["build_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    ta = time.perf_counter()
    sw.add_dense_batch(corpus[n0:])  # absorbed in place: AddBatch
    torch.cuda.synchronize()
    out["add_s"] = time.perf_counter() - ta
    _require(sw.built and sw.method.data_qty() == n, lambda: "sw-graph add_batch rebuilt or lost rows")
    sw.set_query_time_params(Params(efSearch=100))
    _, ia = sw.knn_query_batch(corpus[n0:], k)
    self_found = float(np.mean(ia[:, 0] == n0 + np.arange(2048)))
    _require(self_found == 1.0, lambda: f"an added row does not find itself: {self_found}")
    rng = np.random.default_rng(11)
    doomed = rng.choice(n, 2000, replace=False)
    td = time.perf_counter()
    sw.delete_batch(doomed[:1000], strategy="neighbors_only")
    torch.cuda.synchronize()
    t_nb = time.perf_counter() - td
    td = time.perf_counter()
    sw.delete_batch(doomed[1000:], strategy="none")
    torch.cuda.synchronize()
    t_none = time.perf_counter() - td
    chk = sw.method.check_graph()
    out.update(delete_neighbors_only_s=t_nb, delete_none_s=t_none)
    print(f"[swgraph] build {n0} x {DIM}, NN=16 efConstruction=100 waveSize=1024: {out['build_s']:.2f} s, peak "
          f"{out['build_peak_gib']:.3f} GiB; add 2048 rows {out['add_s']:.2f} s (built kept, every added row its own "
          f"first hit); delete 1000 neighbors_only {t_nb:.2f} s, 1000 none {t_none:.2f} s; data_qty "
          f"{sw.method.data_qty()}, check_graph {chk}; {smi}", flush=True)
    _require(chk == zero and sw.method.data_qty() == n - 2000, lambda: f"sw-graph after deletions: {chk}")
    keep = np.setdiff1d(np.arange(n), doomed)
    ex = Index("l2", Params(dim=DIM), method="seq_search", device="cuda")
    ex.add_dense_batch(corpus[keep], ids=keep)
    _, gi = ex.knn_query_batch(queries, k)
    del ex
    rows = {}
    for ef in (20, 50, 100):
        sw.set_query_time_params(Params(efSearch=ef))
        d, i = sw.knn_query_batch(queries, k)
        med = _median_ms(lambda: sw.knn_query_batch(queries, k), reps=3)[0]
        _require(not np.isin(i, doomed).any(), lambda: f"sw-graph efSearch={ef} returned a deleted id")
        rows[ef] = {"recall": _recall_at(i, gi, k), "ms": med, "qps": nq / med * 1e3}
        print(f"[swgraph] efSearch={ef}: recall@{k} {rows[ef]['recall']:.4f} against seq_search over the "
              f"surviving rows, median of 3 {med:.2f} ms, {rows[ef]['qps']:.0f} qps; {smi}", flush=True)
    _require(rows[100]["recall"] >= 0.9, lambda: f"sw-graph recall@10 {rows[100]['recall']} at efSearch=100")
    out["search"] = rows
    tmp = tempfile.mkdtemp(prefix="tk_sw_")
    try:
        d0, i0 = sw.knn_query_batch(queries, k)
        path = os.path.join(tmp, "sw")
        sw.save(path)
        back = Index.load(path, device="cuda")
        back.set_query_time_params(Params(efSearch=100))
        d1, i1 = back.knn_query_batch(queries, k)
        _require(np.array_equal(d0, d1) and np.array_equal(i0, i1) and back.method.data_qty() == sw.method.data_qty(),
                 lambda: "sw-graph results changed after save and load with the deletion mask")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("[swgraph] save/load with the deletion mask: results bit-identical", flush=True)
    del sw, back
    torch.cuda.empty_cache()
    return out


def _dna(n: int, seed: int):
    """n seeded DNA-like strings over ACGT, lengths 24-40."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(24, 41, n)
    chars = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, 40))]
    return [chars[i, :lens[i]].tobytes() for i in range(n)]


def _edited(strings, seed: int):
    """Each string with 1-4 seeded edits (substitute, insert or delete)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in strings:
        b = bytearray(s)
        for _ in range(int(rng.integers(1, 5))):
            op, pos, ch = int(rng.integers(0, 3)), int(rng.integers(0, len(b) + 1)), b"ACGT"[int(rng.integers(0, 4))]
            if op == 0 and pos < len(b):
                b[pos] = ch
            elif op == 1:
                b.insert(pos, ch)
            elif pos < len(b):
                del b[pos]
        out.append(bytes(b))
    return out


def _phase_string(smi):
    """(c) [string]: leven and normleven over 100,000 seeded DNA-like
    strings and 256 queries made by 1-4 seeded edits of corpus strings:
    seq_search k=10 (ms a batch), distances against the native Levenshtein
    over every pair for 16 queries; HNSW over 5,000 of the strings.
    Returns the numbers it printed."""
    import torch
    from tpu_knn_torch import DataKind, DistKind, Index, Params
    from tpu_knn_torch.io import native
    from tpu_knn_torch.ops.distance import block_elems

    n, nq, k, n_check = 100_000, 256, K, 16
    corpus = _dna(n, 0)
    queries = _edited([corpus[int(i)] for i in np.random.default_rng(1).integers(0, n, nq)], 2)
    tn = time.perf_counter()
    lib = native.load()
    if lib is None:  # the library did not build: its Python fallback
        lev = np.array([[native.levenshtein(q, x) for x in corpus] for q in queries[:n_check]], np.int64)
    else:  # the library's tk_levenshtein on buffers made once per string
        import ctypes

        def buf(b):
            return (ctypes.c_uint8 * max(len(b), 1)).from_buffer_copy(b or b"\0")

        xb = [(buf(x), len(x)) for x in corpus]
        lev = np.array([[lib.tk_levenshtein(qb, len(q), b, lx) for b, lx in xb]
                        for q in queries[:n_check] for qb in (buf(q),)], np.int64)
    native_s = time.perf_counter() - tn
    lq, lx = np.array([len(q) for q in queries[:n_check]]), np.array([len(x) for x in corpus])
    out = {}
    for name, dt in (("leven", DistKind.INT), ("normleven", DistKind.FLOAT)):
        ix = Index(name, method="seq_search", data_type=DataKind.STRING, dist_type=dt, device="cuda")
        tb = time.perf_counter()
        ix.add_string_batch(corpus)
        ix.build_index()
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - tb
        d, i = ix.knn_query_batch(queries, k)
        med = _median_ms(lambda: ix.knn_query_batch(queries, k), reps=3)[0]
        lq_pad = ix.space.encode_queries(queries)["qc"].shape[1]
        sub = block_elems(torch.device("cuda")) // (nq * (lq_pad + 1))
        if name == "leven":
            want = np.sort(lev, axis=1)[:, :k]
            got_exact = lev[np.arange(n_check)[:, None], i[:n_check]]
        else:
            norm = (lev / np.maximum(lq[:, None], lx[None, :])).astype(np.float32)
            want = np.sort(norm, axis=1)[:, :k]
            got_exact = norm[np.arange(n_check)[:, None], i[:n_check]]
        ok = np.array_equal(d[:n_check], want) and np.array_equal(d[:n_check], got_exact)
        _require(ok, lambda: f"{name}: distances differ from the native Levenshtein for the first {n_check} queries")
        out[name] = {"ms": med, "qps": nq / med * 1e3, "encode_s": enc_s, "route": ix.method.last_route}
        print(f"[string] {name} seq_search {n} strings (lengths 24-40), {nq} queries, k={k}: add + encode "
              f"{enc_s:.2f} s, median of 3 {med:.2f} ms, {nq / med * 1e3:.0f} qps, route {ix.method.last_route}, "
              f"scan chunk {ix.method._chunk} rows, DP blocks of {sub} rows; the first {n_check} queries' distances "
              f"equal the native Levenshtein's over every pair ({native_s:.1f} s on the host); {smi}", flush=True)
        if name == "leven":
            gold_d, scan = d, ix
        del ix
    # 5,000 strings: at 20,000 the build took 91.25 s, more than the phase's
    # share of the script's time (NVIDIA H100 80GB HBM3, 700 W); at 10,000 46.37 s
    # (the whole script took 1292.7 s of command on a slow host, NVIDIA H100 80GB HBM3, 700 W)
    n2 = 5_000
    hs = Index("leven", method="hnsw", data_type=DataKind.STRING, dist_type=DistKind.INT, device="cuda")
    hs.add_string_batch(corpus[:n2])
    tb = time.perf_counter()
    hs.build_index(Params(M=16, efConstruction=100, waveSize=1024))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    chk = hs.method.check_graph()
    ex = Index("leven", method="seq_search", data_type=DataKind.STRING, dist_type=DistKind.INT, device="cuda")
    ex.add_string_batch(corpus[:n2])
    dg, _ = ex.knn_query_batch(queries, k)
    hs.set_query_time_params(Params(efSearch=100))
    dh, ih = hs.knn_query_batch(queries, k)
    med = _median_ms(lambda: hs.knn_query_batch(queries, k), reps=3)[0]
    rec = _tie_recall(dh, dg, k)
    print(f"[string] hnsw leven {n2} strings, M=16 efConstruction=100 waveSize=1024: build {build_s:.2f} s, "
          f"check_graph {chk}, tie-aware recall@{k} at efSearch=100 {rec:.4f} against the scan, median of 3 "
          f"{med:.2f} ms; {smi}", flush=True)
    _require(chk == {"self_links": 0, "dup_links": 0, "oob_links": 0} and rec >= 0.9,
             lambda: f"hnsw leven: check_graph {chk}, recall {rec}")
    out["hnsw"] = {"n": n2, "build_s": build_s, "recall": rec, "ms": med}
    del hs, ex, scan, gold_d
    torch.cuda.empty_cache()
    return out


def _sqfd_sigs(n: int, seed: int, d: int = 8):
    """n seeded JSON signatures of 8-16 clusters in R^d, and their arrays."""
    rng = np.random.default_rng(seed)
    sigs = []
    for _ in range(n):
        nc = int(rng.integers(8, 17))
        sigs.append((rng.random(nc), rng.standard_normal((nc, d))))
    txt = [json.dumps({"weights": w.tolist(), "centers": c.tolist()}) for w, c in sigs]
    return txt, sigs


def _sqfd_f64(f, qsigs, xsigs, blk: int = 1000):
    """Float64 SQFD of every (query, corpus) signature pair, in numpy:
    sqrt(s_q + s_x - 2 w_q^T f(L2(c_q, c_x)) w_x); padding clusters carry
    weight 0."""
    def pack(sigs):
        cm = max(w.shape[0] for w, _ in sigs)
        w = np.zeros((len(sigs), cm))
        c = np.zeros((len(sigs), cm, sigs[0][1].shape[1]))
        for i, (wi, ci) in enumerate(sigs):
            w[i, :wi.shape[0]], c[i, :ci.shape[0]] = wi, ci
        return w, c

    def l2(a, b):  # [A, d] x [B, d] -> [A, B]
        return np.sqrt(np.maximum((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2 * a @ b.T, 0.0))

    def self_terms(w, c):
        return np.array([wi @ f(l2(ci, ci)) @ wi for wi, ci in zip(w, c)])

    (qw, qc), (xw, xc) = pack(qsigs), pack(xsigs)
    nq, cq, d = qc.shape
    cx = xc.shape[1]
    qs, xs = self_terms(qw, qc), self_terms(xw, xc)
    out = np.zeros((nq, len(xsigs)))
    for s in range(0, len(xsigs), blk):
        e = min(s + blk, len(xsigs))
        fd = f(l2(qc.reshape(nq * cq, d), xc[s:e].reshape((e - s) * cx, d))).reshape(nq, cq, e - s, cx)
        cross = np.einsum("qi,qixj,xj->qx", qw, fd, xw[s:e])
        out[:, s:e] = np.sqrt(np.maximum(qs[:, None] + xs[None, s:e] - 2 * cross, 0.0))
    return out


def _check_f64(label, d, ids, ref, k: int):
    """Ids a top-k of the float64 distances ``ref`` up to ties, every
    distance within rtol 5e-3 / atol 1e-5 of its id's f64 value."""
    kth = np.sort(ref, axis=1)[:, k - 1:k]
    got = ref[np.arange(ref.shape[0])[:, None], ids]
    tol = 1e-5 + 5e-3 * np.abs(got)
    _require(bool((ids >= 0).all() and (np.abs(d - got) <= tol).all()), lambda: f"{label}: a distance off its f64 value")
    _require(bool((got <= kth + 1e-5 + 5e-3 * np.abs(kth)).all()), lambda: f"{label}: an id outside the f64 top-{k}")
    return int(np.sum(ids != np.argsort(ref, axis=1, kind="stable")[:, :k]))


def _phase_small(smi, corpus, queries):
    """(d) [sqfd]: the three SQFD names over 10,000 signatures of 8-16
    clusters in d=8, sparse_dense_fusion over 10,000 objects of a 128-d
    dense and a sparse_like component, range on one of each, each against a
    float64 numpy oracle; dummy with doSeqSearch=1 over 20,000 of phase 4's
    rows. Returns the numbers it printed."""
    import scipy.sparse as sps
    import torch
    from tpu_knn_torch import DataKind, Index, Params
    from tpu_knn_torch.eval.datasets import sparse_like
    from tpu_knn_torch.ops import groupmin as GM

    n, nq, k = 10_000, 64, K
    out = {}
    xt, xs = _sqfd_sigs(n, 3)
    qt, qs = _sqfd_sigs(nq, 4)
    fns = {"sqfd_minus_func": lambda d: -d, "sqfd_heuristic_func": lambda d: 1.0 / (1.0 + d),
           "sqfd_gaussian_func": lambda d: np.exp(-1.0 * d * d)}
    for name, f in fns.items():
        ix = Index(name, Params(alpha=1.0), method="seq_search", data_type=DataKind.STRING, device="cuda")
        ix.add_string_batch(xt)
        d, i = ix.knn_query_batch(qt, k)
        med = _median_ms(lambda: ix.knn_query_batch(qt, k), reps=3)[0]
        ref = _sqfd_f64(f, qs, xs)
        diff = _check_f64(f"{name} kNN", d, i, ref, k)
        rng_line = ""
        if name == "sqfd_gaussian_func":
            radius = float(np.median(np.sort(ref, axis=1)[:, k - 1]))
            res = ix.range_query_batch(qt, radius)
            for r, rr in enumerate(res):
                want = set(np.nonzero(ref[r] <= radius)[0].tolist())
                sym = set(rr.ids.tolist()) ^ want
                _require(all(abs(ref[r, j] - radius) <= 5e-3 * radius for j in sym),
                         lambda: f"{name} range: query {r} differs from the f64 oracle beyond the radius's bound")
            rng_line = f"; range at {radius:.4f}: id sets as the f64 oracle's up to its bound"
        out[name] = {"ms": med}
        print(f"[sqfd] {name} seq_search {n} signatures (8-16 clusters, d=8), {nq} queries: median of 3 {med:.2f} ms, "
              f"ids against the f64 oracle: {diff} differ on ties{rng_line}; {smi}", flush=True)
        del ix
    # sparse_dense_fusion: one 128-d dense and one sparse_like component
    sp = sparse_like(n + nq, vocab=30_000, nnz=64, seed=0)
    dense = corpus[:n + nq] / 100.0
    objs = [json.dumps({"dense": [dense[j].tolist()], "sparse": [[np.asarray(sp[j][0]).tolist(),
                                                                   np.asarray(sp[j][1], np.float64).tolist()]]})
            for j in range(n + nq)]
    fx = Index("sparse_dense_fusion", Params(indexWeights="1.0,1.0", queryWeights="0.5,2.0"), method="seq_search",
               data_type=DataKind.STRING, device="cuda")
    fx.add_string_batch(objs[:n])
    d, i = fx.knn_query_batch(objs[n:], k)
    med = _median_ms(lambda: fx.knn_query_batch(objs[n:], k), reps=3)[0]
    csr = sps.csr_matrix((np.concatenate([np.asarray(v, np.float64) for _, v in sp]),
                          np.concatenate([np.asarray(c) for c, _ in sp]) - 1,
                          np.concatenate([[0], np.cumsum([len(c) for c, _ in sp])])), shape=(n + nq, 30_000))
    dd = dense.astype(np.float64)
    ref = -(0.5 * (dd[n:] @ dd[:n].T) + 2.0 * (csr[n:] @ csr[:n].T).toarray())
    diff = _check_f64("sparse_dense_fusion kNN", d, i, ref, k)
    radius = float(np.median(np.sort(ref, axis=1)[:, k - 1]))
    res = fx.range_query_batch(objs[n:], radius)
    for r, rr in enumerate(res):
        sym = set(rr.ids.tolist()) ^ set(np.nonzero(ref[r] <= radius)[0].tolist())
        _require(all(abs(ref[r, j] - radius) <= 5e-3 * abs(radius) + 1e-5 for j in sym),
                 lambda: f"fusion range: query {r} differs from the f64 oracle beyond the radius's bound")
    out["sparse_dense_fusion"] = {"ms": med}
    print(f"[sqfd] sparse_dense_fusion seq_search {n} objects (128-d dense + sparse_like), {nq} queries: median of 3 "
          f"{med:.2f} ms, ids against the f64 oracle: {diff} differ on ties; range at {radius:.4f}: id sets as the "
          f"f64 oracle's up to its bound; {smi}", flush=True)
    del fx
    # dummy: doSeqSearch=1 is seq_search, bit for bit, on the f32 kernel
    n3 = 20_000
    ref_ix = Index("l2", Params(dim=DIM), method="seq_search", device="cuda")
    ref_ix.add_dense_batch(corpus[:n3])
    d0, i0 = ref_ix.knn_query_batch(queries, k)
    dm = Index("l2", Params(dim=DIM), method="dummy", device="cuda")
    dm.add_dense_batch(corpus[:n3])
    dm.build_index(Params(doSeqSearch=1))
    GM.reset_launches()
    d1, i1 = dm.knn_query_batch(queries, k)
    launched = GM.launches["float32"]
    _require(np.array_equal(d0, d1) and np.array_equal(i0, i1) and launched > 0,
             lambda: f"dummy doSeqSearch=1: results differ from seq_search or groupmin_f32 not launched ({launched})")
    empty = Index("l2", Params(dim=DIM), method="dummy", device="cuda")
    empty.add_dense_batch(corpus[:n3])
    de, ie = empty.knn_query_batch(queries[:8], k)
    _require(bool((ie == -1).all() and np.isinf(de).all()), lambda: "dummy without doSeqSearch returned results")
    print(f"[sqfd] dummy doSeqSearch=1 over {n3} rows: bit-equal to seq_search, groupmin_f32 launched {launched}; "
          f"without it every result empty; {smi}", flush=True)
    out["dummy_launches"] = launched
    return out


# ---------------- phase 21: the CLI and the mesh layer ----------------


def _cli_tables(path: str) -> dict:
    """{title: [row dicts]} of a CLI result file, qps (a timing) dropped."""
    out, title, head = {}, None, None
    with open(path) as f:
        for line in f.read().splitlines():
            if line.startswith("=== "):
                title, head = line.strip("= "), None
                out[title] = []
            elif title and line and not line.startswith("-"):
                cells = [c.strip() for c in line.split("  ") if c.strip()]
                if head is None:
                    head = cells
                else:
                    row = dict(zip(head, cells))
                    row.pop("qps", None)
                    out[title].append(row)
    return out


def _phase_cli(smi, corpus, queries):
    """[cli]: tpu_knn_torch.cli.main in-process over phase 4's 1,000,000 rows
    written as .fvecs (seq_search, 2048 bootstrap queries, recall 1, the f32
    kernel launched); hnsw over 10,000 of them with --queryFile, --saveIndex
    and --loadIndex (equal tables); one ``python -m tpu_knn_torch``
    subprocess. Returns the numbers it printed."""
    import os
    import shutil
    import tempfile

    from tpu_knn_torch import cli
    from tpu_knn_torch.io.native import write_vecs
    from tpu_knn_torch.ops import groupmin as GM

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        big, small, qf = (os.path.join(tmp, f) for f in ("sift1m.fvecs", "sift10k.fvecs", "q.fvecs"))
        write_vecs(big, corpus)
        write_vecs(small, corpus[:10_000])  # cut from 20,000 (a slow host passed the script's 1200 s)
        write_vecs(qf, queries)
        base = ["--spaceType", "l2", "--spaceParams", f"dim={DIM}", "--device", "cuda"]
        res = os.path.join(tmp, "seq.txt")
        GM.reset_launches()
        ts = time.perf_counter()
        rc = cli.main(base + ["--dataFile", big, "--method", "seq_search", "--knn", str(K), "--maxNumQuery",
                              str(N_QUERIES), "--testSetQty", "1", "--outFile", res])
        secs = time.perf_counter() - ts
        launched = GM.launches["float32"]
        rows = _cli_tables(res)[f"kNN k={K} (method=seq_search, space=l2)"]
        print(f"[cli] python -m tpu_knn_torch equivalent, seq_search over {len(corpus)} fvecs rows, {N_QUERIES} "
              f"bootstrap queries, k={K}: rc {rc}, {secs:.2f} s end to end (read, split, two uploads, gold, "
              f"warm-up, timed run), groupmin_f32 launches {launched}, row {rows[0]}; {smi}", flush=True)
        _require(rc == 0 and rows[0]["recall"] == "1", lambda: f"cli seq_search: rc {rc}, row {rows[0]}")
        _require(launched > 0, lambda: "cli seq_search did not launch groupmin_f32")
        out.update(seq_s=secs, seq_launches=launched)

        hn = base + ["--dataFile", small, "--queryFile", qf, "--method", "hnsw", "--createIndex",
                     "M=16,efConstruction=200", "--queryTimeParams", "efSearch=20", "--queryTimeParams",
                     "efSearch=100", "--knn", str(K)]
        saved, built_txt, loaded_txt = (os.path.join(tmp, f) for f in ("hnsw", "built.txt", "loaded.txt"))
        ts = time.perf_counter()
        _require(cli.main(hn + ["--saveIndex", saved, "--outFile", built_txt]) == 0, lambda: "cli hnsw save")
        t_build = time.perf_counter() - ts
        ts = time.perf_counter()
        _require(cli.main(hn + ["--loadIndex", saved, "--outFile", loaded_txt]) == 0, lambda: "cli hnsw load")
        t_load = time.perf_counter() - ts
        a, b = _cli_tables(built_txt), _cli_tables(loaded_txt)
        _require(a == b and a, lambda: f"cli hnsw: the loaded index's table differs: {a} vs {b}")
        rows = a[f"kNN k={K} (method=hnsw, space=l2)"]
        print(f"[cli] hnsw over 10,000 rows, --queryFile {N_QUERIES} queries: build+save+sweep {t_build:.2f} s, "
              f"load+sweep {t_load:.2f} s, equal tables: {rows}; {smi}", flush=True)
        _require(float(rows[1]["recall"]) >= 0.99, lambda: f"cli hnsw recall at efSearch=100: {rows[1]}")
        out.update(hnsw_build_s=t_build, hnsw_load_s=t_load, hnsw_rows=rows)

        sub_txt = os.path.join(tmp, "sub.txt")
        ts = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "tpu_knn_torch"] + base
                           + ["--dataFile", small, "--queryFile", qf, "--method", "seq_search", "--knn", str(K),
                              "--outFile", sub_txt], capture_output=True, text=True, timeout=300)
        t_sub = time.perf_counter() - ts
        _require(r.returncode == 0, lambda: f"python -m tpu_knn_torch: rc {r.returncode}: {r.stderr[-2000:]}")
        rows = _cli_tables(sub_txt)[f"kNN k={K} (method=seq_search, space=l2)"]
        _require(rows[0]["recall"] == "1", lambda: f"python -m tpu_knn_torch: {rows[0]}")
        print(f"[cli] subprocess python -m tpu_knn_torch --device cuda, seq_search over 10,000 rows: rc 0 in "
              f"{t_sub:.2f} s, recall {rows[0]['recall']}; {smi}", flush=True)
        out["subprocess_s"] = t_sub
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _tie_equal(label, d, i, d_ref, i_ref, q_dev, x_dev):
    """Ids equal the reference's except where the two ids' float64 squared
    distances lie within twice the f32 norm-identity bound of each other
    (an f32 tie, as _check_against_oracle defines it). Returns the number of
    slots that differ."""
    import torch

    diff = i != i_ref
    if not diff.any():
        return 0
    rows, cols = np.nonzero(diff)
    q = q_dev[torch.from_numpy(rows).to(q_dev.device)].double()
    xa = x_dev[torch.from_numpy(i[rows, cols].astype(np.int64)).to(x_dev.device)].double()
    xb = x_dev[torch.from_numpy(i_ref[rows, cols].astype(np.int64)).to(x_dev.device)].double()
    ea, eb = ((xa - q) ** 2).sum(1), ((xb - q) ** 2).sum(1)
    qn = q.norm(dim=1)
    bound = (q.shape[1] + 3) * U * (qn + torch.maximum(xa.norm(dim=1), xb.norm(dim=1))) ** 2
    bad = (ea - eb).abs() > 2.0 * bound
    _require(not bool(bad.any()), lambda: f"{label}: {int(bad.sum())} ids differ beyond f32 ties")
    return int(diff.sum())


def _phase_mesh(smi, corpus, queries, i10, d10):
    """[mesh]: (b) the sharded exact scan, Index(..., method="seq_search",
    mesh=4) over phase 4's 1M rows against phase 4's ids, timed in turns
    with the single-device index, range at phase 9's radius and the
    two-tier merge; (c) the sharded HNSW over 20,000 of HNSW-100k's rows
    (stacked waves), recall, check_graph and save/load, then NN-descent
    over 4 x 5,000 rows twice from one seed. Returns the numbers it
    printed."""
    import os
    import shutil
    import tempfile

    import torch
    from tpu_knn_torch import Index, Params
    from tpu_knn_torch.eval.datasets import sift_like
    from tpu_knn_torch.ops import groupmin as GM
    from tpu_knn_torch.parallel import hnsw_sharded as HS, sharded as SH
    from tpu_knn_torch.parallel.mesh import make_mesh2

    out = {}
    dev = torch.device("cuda", 0)
    # ---- (b) the sharded exact scan ----
    single = Index("l2", Params(dim=DIM), method="seq_search", device="cuda")
    single.add_dense_batch(corpus)
    single.build_index()
    mesh_ix = Index("l2", Params(dim=DIM), method="seq_search", mesh=4, device="cuda")
    mesh_ix.add_dense_batch(corpus)
    torch.cuda.synchronize()
    tb = time.perf_counter()
    mesh_ix.build_index()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    torch.cuda.reset_peak_memory_stats()
    GM.reset_launches()
    dm, im = mesh_ix.knn_query_batch(queries, K)
    launched = GM.launches["float32"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    m = mesh_ix.method
    phys = len(m.mesh.physical_devices())
    q_dev = torch.from_numpy(queries).to(dev)
    x_dev = torch.from_numpy(corpus).to(dev)
    n_tie = _tie_equal("mesh=4 exact", dm, im, d10, i10, q_dev, x_dev)
    err = _check_exact_distances("mesh=4 exact", dm, im, q_dev, x_dev)
    _require(m.last_routes == ["twopass"] * 4 and launched == 4,
             lambda: f"mesh=4 exact: routes {m.last_routes}, groupmin_f32 launches {launched} (want 4)")
    times = {"single": [], "mesh": []}
    for who in ("single", "mesh", "mesh", "single"):
        ix = single if who == "single" else mesh_ix
        times[who].append(_median_ms(lambda: ix.knn_query_batch(queries, K), 5)[0])
    ms_mesh, ms_single = statistics.median(times["mesh"]), statistics.median(times["single"])
    print(f"[mesh] (b) exact, Index(seq_search, mesh=4) over {len(corpus)} x {DIM}, {N_QUERIES} queries, k={K}: "
          f"4 shards of {m.data.n_local} rows ({m.data.shards[0].ids.shape[0]} with chunk padding) on {phys} "
          f"physical device(s), routes {m.last_routes}, groupmin_f32 launches {launched} a batch, build "
          f"{build_s:.3f} s, peak allocated {peak:.3f} GiB during the query; ids equal phase 4's except {n_tie} "
          f"slots on f32 ties, max |d - f64| {err:.3g}; ms a batch (median of 5, in turns single, mesh, mesh, "
          f"single): mesh {times['mesh']}, single {times['single']}; {smi}", flush=True)
    out.update(build_s=build_s, launches=launched, peak_gib=peak, physical_devices=phys, ms_mesh=ms_mesh,
               ms_single=ms_single, tie_slots=n_tie)

    # (d) one groupmin_f32 launch on shard 0's rows, as the sharded scan makes it
    from tpu_knn_torch.methods import seq_search as SS

    qenc = m.space.encode_queries(queries)
    shard = m.data.shards[0]
    q, qt, xt, scale = SS._kernel_inputs(m.space, qenc, shard)
    xt = xt.contiguous()
    shard_ms = _cuda_ms(lambda: GM.fused_groupmin(q, shard.vecs, qt, xt, scale), 10)
    shard_plain_ms = _cuda_ms(lambda: GM.fused_groupmin_reference(q, shard.vecs, qt, xt, scale), 3)
    shard_bound, shard_by = _bound_ms("float32", q, shard.vecs)
    print(f"[mesh] (d) groupmin_f32 on one shard, Q={q.shape[0]} N={shard.vecs.shape[0]} D={shard.vecs.shape[1]}: "
          f"{shard_ms:.3f} ms a launch (CUDA events, mean of 10; plain {shard_plain_ms:.3f} ms, mean of 3), "
          f"{launched} launches a batch; bound {shard_bound:.3f} ms ({shard_by}), {shard_bound / shard_ms:.1%} of "
          f"it; four launches {4 * shard_ms:.3f} ms against the four-launch bound {4 * shard_bound:.3f} ms; {smi}",
          flush=True)
    out.update(shard_kernel_ms=shard_ms, shard_plain_ms=shard_plain_ms, shard_bound_ms=shard_bound)

    # range at phase 9's radius: the single-device range's id sets
    radius = float(np.median(d10[:, K - 1]))
    ts = time.perf_counter()
    got = mesh_ix.range_query_batch(queries, radius)
    t_range = time.perf_counter() - ts
    ts = time.perf_counter()
    want = single.range_query_batch(queries, radius)
    t_single = time.perf_counter() - ts
    same = all(np.array_equal(np.sort(a.ids), np.sort(b.ids)) for a, b in zip(got, want))
    hits = sum(len(r.ids) for r in got)
    _require(same and len(got) == len(want), lambda: "mesh=4 range: id sets differ from the single-device range")
    print(f"[mesh] (b) range at radius {radius:.6g}: {hits} hits over {len(got)} queries in {t_range:.3f} s "
          f"(the single-device range right after: {t_single:.3f} s), id sets equal to the single-device range's; "
          f"{smi}", flush=True)
    out.update(range_s=t_range, range_single_s=t_single, range_hits=hits)

    # the two-tier merge on a [2, 2] mesh against the flat merge
    d_flat, i_flat = SH.sharded_exact_knn(m.space, qenc, m.data, K, m.mesh)
    d_hier, i_hier = SH.sharded_exact_knn_hier(m.space, qenc, m.data, K, make_mesh2(2, 2, device="cuda"))
    _require(torch.equal(i_flat, i_hier) and torch.equal(d_flat, d_hier),
             lambda: "two-tier merge differs from the flat merge")
    print(f"[mesh] (b) two-tier merge on make_mesh2(2, 2): ids and distances equal to the flat merge; {smi}",
          flush=True)
    del single, mesh_ix, m, qenc, d_flat, i_flat, d_hier, i_hier, x_dev, shard, q, qt, xt
    torch.cuda.empty_cache()

    # ---- (c) the sharded HNSW ----
    # the first 20,000 of HNSW-100k's rows (cut from all 100,000: the whole
    # script passed ~1,050 s with them, PERF.md section 4; then from 40,000:
    # the whole script took 1292.7 s of command on a slow host, NVIDIA H100 80GB HBM3, 700 W), its 2048 queries
    n_cell, nq, k = 100_000, N_QUERIES, K
    n = 20_000
    xall = sift_like(n_cell + nq, DIM, seed=0)
    hx, hq = xall[:n], xall[n_cell:]
    exact = Index("l2", Params(dim=DIM), method="seq_search", device="cuda")
    exact.add_dense_batch(hx)
    _, gi = exact.knn_query_batch(hq, k)
    hix = Index("l2", Params(dim=DIM), mesh=4, device="cuda")  # no method=: hnsw
    hix.add_dense_batch(hx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tb = time.perf_counter()
    hix.build_index(Params(M=16, efConstruction=200, waveSize=1024, parallelBuild=1))
    torch.cuda.synchronize()
    hb = time.perf_counter() - tb
    hpeak = torch.cuda.max_memory_allocated() / 2**30
    _require(isinstance(hix.method, HS.ShardedHnsw), lambda: f"mesh=4 hnsw built {type(hix.method)}")
    chk = hix.method.check_graph()
    zero = {"self_links": 0, "dup_links": 0, "oob_links": 0}
    _require(all(c == zero for c in chk), lambda: f"mesh=4 hnsw check_graph {chk}")
    rows = {}
    for ef, floor in ((20, 0.95), (100, 0.99)):
        hix.set_query_time_params(Params(efSearch=ef))
        d, i = hix.knn_query_batch(hq, k)
        best = min(_median_ms(lambda: hix.knn_query_batch(hq, k), 1)[0] for _ in range(3))
        rec = _recall_at(i, gi, k)
        rows[ef] = {"recall": rec, "ms": best, "qps": nq / best * 1e3}
        _require(rec >= floor, lambda: f"mesh=4 hnsw recall@{k} {rec} < {floor} at efSearch={ef}")
    print(f"[mesh] (c) hnsw, Index(l2, mesh=4) over {n} x {DIM} (4 shards of {n // 4}, M=16, efConstruction=200, "
          f"waveSize=1024, stacked waves): build {hb:.2f} s, peak allocated {hpeak:.3f} GiB, check_graph zero on "
          f"every shard; recall@{k} and qps (best of 3) {json.dumps(rows)}; {smi}", flush=True)
    out.update(hnsw_build_s=hb, hnsw_peak_gib=hpeak, hnsw=rows)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        p = os.path.join(tmp, "sh")
        hix.set_query_time_params(Params(efSearch=100))
        d0, i0 = hix.knn_query_batch(hq, k)
        hix.save(p)
        with np.load(p + ".idx.npz") as z:
            header = json.loads(bytes(z["__header__"].tobytes()).decode())
        back = Index.load(p, device="cuda")
        back.set_query_time_params(Params(efSearch=100))
        d1, i1 = back.knn_query_batch(hq, k)
        _require(header["mesh_devices"] == 4 and np.array_equal(d0, d1) and np.array_equal(i0, i1),
                 lambda: f"mesh=4 hnsw save/load: header mesh_devices {header['mesh_devices']}, results differ")
        print(f"[mesh] (c) save/load: mesh_devices {header['mesh_devices']} in the header, results bit-identical; "
              f"{smi}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del hix, back, exact
    torch.cuda.empty_cache()

    # NN-descent per shard over 4 x 5,000 rows, twice from one seed
    states, tn = [], []
    for _ in range(2):
        nix = Index("l2", Params(dim=DIM), mesh=4, device="cuda")
        nix.add_dense_batch(hx)
        tb = time.perf_counter()
        nix.build_index(Params(M=16, efConstruction=100, buildAlgo="nndescent"))
        torch.cuda.synchronize()
        tn.append(time.perf_counter() - tb)
        chk = nix.method.check_graph()
        _require(all(c == zero for c in chk), lambda: f"mesh=4 nndescent check_graph {chk}")
        states.append(nix.method.state_arrays())
    same = states[0].keys() == states[1].keys() and all(
        torch.equal(torch.from_numpy(np.asarray(states[0][key])), torch.from_numpy(np.asarray(states[1][key])))
        for key in states[0])
    _require(same, lambda: "mesh=4 nndescent: two builds from one seed differ")
    nix.set_query_time_params(Params(efSearch=50))
    rec4 = _recall_at(nix.knn_query_batch(hq, k)[1], gi, k)  # the same 20,000 rows
    print(f"[mesh] (c) nndescent, mesh=4 over 4 x 5,000 rows: builds {tn[0]:.2f} s and {tn[1]:.2f} s, check_graph "
          f"zero on every shard, the two graphs equal (torch.equal); recall@{k} at efSearch=50 {rec4:.4f}; {smi}",
          flush=True)
    out.update(nnd_build_s=tn, nnd_recall=rec4)
    return out


def main() -> int:
    import torch

    # ---- 1. environment ----
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(smi, flush=True)
    # the exact f32 tier: every f32 matmul on the path must be IEEE f32
    _require(torch.backends.cuda.matmul.allow_tf32 is False, lambda: "TF32 matmuls are enabled")
    _require(torch.get_float32_matmul_precision() == "highest",
             lambda: f"float32 matmul precision is {torch.get_float32_matmul_precision()!r}")
    from tpu_knn_torch import Index, Params
    from tpu_knn_torch.core.dataset import DenseDeviceData
    from tpu_knn_torch.eval.datasets import sift_like
    from tpu_knn_torch.methods import seq_search as SS
    from tpu_knn_torch.ops import groupmin as GM
    from tpu_knn_torch.spaces.dense import L2SqrSiftSpace, ensure_cert_metadata

    dev = torch.device("cuda", 0)
    t0 = _phase("environment", t0)

    # ---- 2. build ----
    libs = GM.build_all()
    root = GM.BUILD_DIR.parent.parent
    for name, lib in libs.items():
        print(f"[build] {lib.relative_to(root)} from {GM.SOURCES[name].relative_to(root)} for sm_90a; "
              + " | ".join(_ptxas_summary(GM.build_log.get(name, ""))), flush=True)
        for ln in GM.build_log.get(name, "").splitlines():
            if "warning" in ln.lower():
                print(f"[build] {name}: {ln.strip()}", flush=True)
        # ptxas reports what it does to the wgmma pipeline as "info" remarks:
        # C7514/C7515, the wgmmas of an instance serialized; C7519, a
        # warpgroup.arrive put in before a wgmma
        remarks = _ptxas_remarks(GM.build_log.get(name, ""))
        if remarks:
            print(f"[build] {name}: ptxas remarks per instance {json.dumps(remarks)}", flush=True)
    print(f"[build] all kernels in {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = _phase("build", t0)

    # ---- data (host numpy, made from a seed; set-up) ----
    xall = sift_like(N_CORPUS + N_QUERIES, DIM, seed=0)
    corpus, queries = xall[:N_CORPUS], xall[N_CORPUS:]
    t0 = _phase(f"data: sift_like({N_CORPUS + N_QUERIES}, {DIM}, seed=0)", t0)

    # ---- 3. kernel against its plain version (f64) ----
    max_abs_err = 0.0
    xs = torch.from_numpy(corpus[:N_KERNEL_CHECK]).to(dev)
    xts = (xs * xs).sum(1)
    for nq in (N_QUERIES, 1000):
        q = torch.from_numpy(queries[:nq]).to(dev)
        qt = (q * q).sum(1)
        out = GM.fused_groupmin(q, xs, qt, xts, -2.0)
        torch.cuda.synchronize()
        ref = GM.fused_groupmin_reference(q.double(), xs.double(), qt.double(), xts.double(), -2.0)
        bound, mag = _groupmin_bound(q, xs, qt, xts, -2.0)
        err = (out.double() - ref).abs()
        ratio = float((err / bound).max())
        max_abs_err = max(max_abs_err, float(err.max()))
        print(f"[kernel] Q={nq} N={N_KERNEL_CHECK} D={DIM}: max |kernel - f64 plain| "
              f"{float(err.max()):.4g}, max relative {float((err / mag).max()):.3g} "
              f"(D*u = {DIM * U:.3g}), max error/bound {ratio:.3g}", flush=True)
        _require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                 lambda: f"kernel output {tuple(out.shape)} not finite or not {tuple(ref.shape)}")
        _require(ratio <= 1.0, lambda: f"kernel outside the f32 bound at Q={nq}: {ratio}")
    # the tensor-core tiers on the same rows: int8 on their uint8 rounding,
    # encoded as l2sqr_sift encodes them; bf16x3 and bf16 on the f32 rows
    kernel_err = {"int8": 0.0, "high": 0.0, "bfloat16": 0.0}
    cu8, qu8 = np.rint(corpus).astype(np.uint8), np.rint(queries).astype(np.uint8)
    a8, t8 = L2SqrSiftSpace._encode_mat(cu8[:N_KERNEL_CHECK])
    x8, xt8 = torch.from_numpy(a8).to(dev), torch.from_numpy(t8).to(dev)
    slab = DenseDeviceData(vecs=xs, ids=torch.arange(N_KERNEL_CHECK, dtype=torch.int32, device=dev),
                           count=N_KERNEL_CHECK, dim=DIM)
    ensure_cert_metadata(slab)
    for nq in (N_QUERIES, 1000):
        aq, tq = L2SqrSiftSpace._encode_mat(qu8[:nq])
        q8, qt8 = torch.from_numpy(aq).to(dev), torch.from_numpy(tq).to(dev)
        out = GM.fused_groupmin(q8, x8, qt8, xt8, -2.0)
        torch.cuda.synchronize()
        ref = GM.fused_groupmin_reference(q8, x8, qt8, xt8, -2.0)
        err = float((out - ref).abs().max())
        kernel_err["int8"] = max(kernel_err["int8"], err)
        print(f"[kernel] int8 Q={nq} N={N_KERNEL_CHECK} D={DIM}: max |kernel - plain| {err:.4g}, "
              f"bit-equal {torch.equal(out, ref)}", flush=True)
        _require(torch.equal(out, ref), lambda: f"int8 kernel differs from its plain version at Q={nq}")
        q = torch.from_numpy(queries[:nq]).to(dev)
        qt = (q * q).sum(1)
        f32 = GM.fused_groupmin(q, xs, qt, xts, -2.0)
        _, mag = _groupmin_bound(q, xs, qt, xts, -2.0)
        for tier in ("high", "bfloat16"):
            out = GM.fused_groupmin(q, xs, qt, xts, -2.0, precision=tier)
            torch.cuda.synchronize()
            ref = GM.fused_groupmin_reference(q, xs, qt, xts, -2.0, precision=tier)
            diff = (out.double() - ref.double()).abs()
            rel = float((diff / mag).max())
            kernel_err[tier] = max(kernel_err[tier], float(diff.max()))
            eps = SS._pass1_eps(q, slab, -2.0, tier).double()
            dev_f32 = (out.double() - f32.double()).abs().amax(dim=1)
            ratio = float((dev_f32 / eps).max())
            print(f"[kernel] {tier} Q={nq} N={N_KERNEL_CHECK} D={DIM}: max |kernel - plain| "
                  f"{float(diff.max()):.4g}, relative to the magnitude {rel:.3g} (limit 1e-5); "
                  f"max over queries of max_g |kernel - f32 kernel| / eps {ratio:.3g} "
                  f"(eps median {float(eps.median()):.4g})", flush=True)
            _require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                     lambda: f"{tier} kernel output not finite or not {tuple(ref.shape)}")
            _require(rel <= 1e-5, lambda: f"{tier} kernel vs plain at Q={nq}: {rel} of the magnitude")
            _require(ratio <= 1.0, lambda: f"{tier} kernel beyond eps of the f32 kernel at Q={nq}: {ratio}")
    del xs, xts, x8, xt8, slab
    _edge_sweep(dev, kernel_err)
    _edge_sweep_i8(dev, kernel_err)
    t0 = _phase("kernel vs plain", t0)

    # ---- 4. main path ----
    idx = Index("l2", Params(dim=DIM), method="seq_search", device="cuda")
    tb = time.perf_counter()
    idx.add_dense_batch(corpus)
    idx.build_index()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    torch.cuda.reset_peak_memory_stats()
    GM.reset_launches()
    d10, i10 = idx.knn_query_batch(queries, K)
    launches = GM.launches["float32"]
    route = idx.method.last_route
    peak10 = torch.cuda.max_memory_allocated()
    print(f"[main] build {build_s:.3f} s for {N_CORPUS} x {DIM}; first query: route {route}, "
          f"groupmin launches {launches}", flush=True)
    print(f"[memory] index tensors {idx.memory_usage_bytes() / 2**30:.3f} GiB; peak allocated "
          f"during the k={K} query {peak10 / 2**30:.3f} GiB", flush=True)
    _require(route == "twopass", lambda: f"main path took the {route} route")
    _require(launches > 0, lambda: "the main path did not launch the group-min kernel")
    _require(d10.shape == (N_QUERIES, K) and i10.shape == (N_QUERIES, K),
             lambda: f"result shapes {d10.shape}, {i10.shape}")
    _require(np.isfinite(d10).all() and (np.diff(d10, axis=1) >= 0).all(),
             lambda: "distances not finite or not ascending")

    med, tmin, tmax = _median_ms(lambda: idx.knn_query_batch(queries, K))
    print(f"[main] knn_query_batch Q={N_QUERIES} k={K} over {N_CORPUS} x {DIM}: median "
          f"{med:.3f} ms of 7 (min {tmin:.3f}, max {tmax:.3f}), "
          f"{N_QUERIES / med * 1e3:.1f} qps on {smi}", flush=True)

    # per-stage device times of the same query (CUDA events)
    space, data = idx.space, idx.method.data
    stages, qenc = _breakdown(idx, queries, K)
    print("[breakdown] device ms per stage: " + json.dumps({k: round(v, 4) for k, v in stages.items()}),
          flush=True)

    # the kernel against its plain version at the main path's shapes
    scale, _, _ = space.pass1_affine()
    qk = qenc["q"]
    qtk = qenc["q_term"].contiguous()
    xtk = (data.extra["pad"] + data.row_term).contiguous()
    ms = _cuda_ms(lambda: GM.fused_groupmin(qk, data.vecs, qtk, xtk, scale), 10)
    plain_ms = _cuda_ms(lambda: GM.fused_groupmin_reference(qk, data.vecs, qtk, xtk, scale), 3)
    k_out = GM.fused_groupmin(qk, data.vecs, qtk, xtk, scale)
    p_out = GM.fused_groupmin_reference(qk, data.vecs, qtk, xtk, scale)
    bound, _ = _groupmin_bound(qk, data.vecs, qtk, xtk, scale)
    kp = float(((k_out.double() - p_out.double()).abs() / (2 * bound)).max())
    flops = 2.0 * qk.shape[0] * data.vecs.shape[0] * data.vecs.shape[1]
    bound_ms = {"float32": _bound_ms("float32", qk, data.vecs)}
    print(f"[kernel] main-path shapes Q={qk.shape[0]} N={data.vecs.shape[0]} D={data.vecs.shape[1]}: "
          f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms "
          f"({flops / plain_ms / 1e9:.1f} TFLOP/s); |kernel - plain| / (2 * bound) max {kp:.3g}; "
          f"bound {bound_ms['float32'][0]:.3f} ms ({bound_ms['float32'][1]}), "
          f"{bound_ms['float32'][0] / ms:.1%} of it; {smi}", flush=True)
    _require(kp <= 1.0, lambda: f"kernel vs plain at the main path's shapes: {kp} of the bound")
    t0 = _phase("main path", t0)

    # ---- 22 (a)-(c). async on phase 4's index ----
    asy = _phase_async_scan(smi, idx, queries, d10, i10, med)
    t0 = _phase("async on the 1M scan", t0)

    # ---- 5. float64 oracle ----
    q_dev = torch.from_numpy(queries).to(dev)
    x_dev = torch.from_numpy(corpus).to(dev)
    _check_against_oracle("knn_query_batch k=10", i10, d10, q_dev, x_dev, K)
    del x_dev
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    d100, i100 = idx.knn_query_batch(queries, 100)
    print(f"[memory] peak allocated during the k=100 query "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    x_dev = torch.from_numpy(corpus).to(dev)
    _check_against_oracle("knn_query_batch k=100", i100, d100, q_dev, x_dev, 100)
    one = idx.knn_query(queries[0], K)
    _require(len(one) == K, lambda: f"knn_query returned {len(one)} results")
    _check_against_oracle("knn_query", one.ids[None, :], one.dists[None, :], q_dev[:1], x_dev, K)
    # both routes of _plan_knn at small sizes: 3000 rows stay single-pass,
    # 20000 rows padded to 1024-row chunks go two-pass
    for n, params, want in ((3000, {}, "single"), (20000, {"chunkSize": 1024}, "twopass")):
        small = Index("l2", Params(dim=DIM), method="seq_search", device="cuda")
        small.add_dense_batch(corpus[:n])
        small.build_index(Params(params))
        ds, is_ = small.knn_query_batch(queries[:100], K)
        _require(small.method.last_route == want,
                 lambda: f"{n} rows took the {small.method.last_route} route")
        _check_against_oracle(f"{want} route, {n} rows", is_, ds, q_dev[:100], x_dev[:n], K)
    t0 = _phase("oracle", t0)

    # ---- 6. the int8 path: l2sqr_sift over the uint8 rounding of the corpus ----
    sidx = Index("l2sqr_sift", method="seq_search", data_type="dense_uint8_vector",
                 dist_type="int", device="cuda")
    tb = time.perf_counter()
    sidx.add_uint8_batch(cu8)
    sidx.build_index()
    torch.cuda.synchronize()
    build8_s = time.perf_counter() - tb
    GM.reset_launches()
    d8, i8 = sidx.knn_query_batch(qu8, K)
    launches8 = dict(GM.launches)
    route8 = sidx.method.last_route
    print(f"[int8] build {build8_s:.3f} s for {N_CORPUS} x {DIM} uint8; first query: route {route8}, "
          f"launches {launches8}", flush=True)
    _require(route8 == "twopass", lambda: f"the int8 path took the {route8} route")
    _require(launches8["int8"] > 0 and launches8["float32"] == 0,
             lambda: f"the int8 path launched {launches8}")
    med8, tmin8, tmax8 = _median_ms(lambda: sidx.knn_query_batch(qu8, K))
    print(f"[int8] knn_query_batch Q={N_QUERIES} k={K} over {N_CORPUS} x {DIM} uint8: median "
          f"{med8:.3f} ms of 7 (min {tmin8:.3f}, max {tmax8:.3f}), {N_QUERIES / med8 * 1e3:.1f} qps "
          f"(f32 path {med:.3f} ms) on {smi}", flush=True)
    stages8, qenc8 = _breakdown(sidx, qu8, K)
    print("[int8 breakdown] device ms per stage: "
          + json.dumps({k: round(v, 4) for k, v in stages8.items()}), flush=True)
    sdata = sidx.method.data
    qk8, qtk8 = qenc8["q"], qenc8["q_term"].contiguous()
    xtk8 = (sdata.extra["pad"] + sdata.row_term).contiguous()
    ms8 = _cuda_ms(lambda: GM.fused_groupmin(qk8, sdata.vecs, qtk8, xtk8, -2.0), 10)
    plain_ms8 = _cuda_ms(lambda: GM.fused_groupmin_reference(qk8, sdata.vecs, qtk8, xtk8, -2.0), 3)
    same8 = torch.equal(GM.fused_groupmin(qk8, sdata.vecs, qtk8, xtk8, -2.0),
                        GM.fused_groupmin_reference(qk8, sdata.vecs, qtk8, xtk8, -2.0))
    ops8 = 2.0 * qk8.shape[0] * sdata.vecs.shape[0] * sdata.vecs.shape[1]
    bound_ms["int8"] = _bound_ms("int8", qk8, sdata.vecs)
    print(f"[kernel] int8 main-path shapes Q={qk8.shape[0]} N={sdata.vecs.shape[0]} "
          f"D={sdata.vecs.shape[1]}: kernel {ms8:.3f} ms ({ops8 / ms8 / 1e9:.1f} TOP/s), plain "
          f"{plain_ms8:.3f} ms; bit-equal {same8}; bound {bound_ms['int8'][0]:.3f} ms "
          f"({bound_ms['int8'][1]}), {bound_ms['int8'][0] / ms8:.1%} of it; {smi}", flush=True)
    _require(same8, lambda: "int8 kernel differs from its plain version at the main path's shapes")
    # f32, int8, int8, f32 in turns at the two 1M indexes' shapes; the means of each pair
    f32_run = lambda: GM.fused_groupmin(qk, data.vecs, qtk, xtk, scale)  # noqa: E731
    i8_run = lambda: GM.fused_groupmin(qk8, sdata.vecs, qtk8, xtk8, -2.0)  # noqa: E731
    t4 = [_cuda_ms(f32_run, 10), _cuda_ms(i8_run, 10), _cuda_ms(i8_run, 10), _cuda_ms(f32_run, 10)]
    print("[kernel] int8 against the f32 kernel in turns (f32, int8, int8, f32): "
          + ", ".join(f"{t:.3f}" for t in t4) + f" ms; ratio {(t4[1] + t4[2]) / (t4[0] + t4[3]):.3f} (the "
          f"mma.sync kernel's {OLD_RATIO['int8'][1]}: {OLD_RATIO['int8'][0]} / 13.295 ms, NVIDIA H100 80GB "
          f"HBM3, 700 W); plan {json.dumps(GM.int8_plan(sdata.vecs.shape[1], -2.0))}", flush=True)
    # exact integer oracle: f64 products of uint8 values are exact
    q8_dev = torch.from_numpy(qu8).to(dev)
    x8_dev = torch.from_numpy(cu8).to(dev)
    od2, oi8 = _oracle_sq_topk(q8_dev, x8_dev, K)
    d8_t, i8_t = torch.as_tensor(d8, device=dev).double(), torch.as_tensor(i8, device=dev).long()
    exact8 = ((x8_dev[i8_t].double() - q8_dev.double()[:, None, :]) ** 2).sum(-1)
    distinct = bool((i8_t.sort(dim=1).values.diff(dim=1) > 0).all())
    _require(torch.equal(d8_t, od2), lambda: (
        f"int8 distances differ from the integer oracle at {int((d8_t != od2).sum())} slots"))
    _require(torch.equal(exact8, d8_t) and distinct, lambda: "an int8 id's exact distance is not the one returned")
    print(f"[oracle] int8 path: {N_QUERIES} queries x k={K}: distances equal to the exact integer "
          f"oracle at every slot; ids equal at {int((i8_t == oi8).sum())}/{i8_t.numel()} slots, the "
          f"others at exactly equal distances", flush=True)
    del x8_dev, sdata, qenc8, qk8, qtk8, xtk8
    torch.cuda.empty_cache()
    t0 = _phase("int8 path", t0)

    # ---- 9. range, on the indexes of phases 4 and 6 ----
    _phase_range(idx, sidx, queries, qu8, corpus, cu8, d10, d8, smi)
    del sidx
    torch.cuda.empty_cache()
    t0 = _phase("range", t0)

    # ---- 10. persist, phase 4's index ----
    _phase_persist(idx, queries, d10, i10)
    t0 = _phase("persist", t0)

    # ---- 7. the reduced tiers on the f32 main path ----
    tier_rec = {}
    for tier in ("high", "bfloat16"):
        idx.build_index(Params(pass1Precision=tier))
        GM.reset_launches()
        dt, it = idx.knn_query_batch(queries, K)
        lt = dict(GM.launches)
        m = idx.method
        print(f"[{tier}] route {m.last_route}, launches {lt}, certified {m.last_certified:.6f}, "
              f"redone blocks {m.last_redone_blocks} of {-(-N_QUERIES // SS._CERT_QBLK)}", flush=True)
        _require(m.last_route == "twopass" and lt[tier] > 0,
                 lambda: f"the {tier} path took the {m.last_route} route with launches {lt}")
        _same_results(f"{tier} k={K}", dt, it, d10, i10)
        medt, tmint, tmaxt = _median_ms(lambda: idx.knn_query_batch(queries, K))
        print(f"[{tier}] knn_query_batch Q={N_QUERIES} k={K}: median {medt:.3f} ms of 7 (min "
              f"{tmint:.3f}, max {tmaxt:.3f}), {N_QUERIES / medt * 1e3:.1f} qps; f32 tier "
              f"{med:.3f} ms; {smi}", flush=True)
        d100t, i100t = idx.knn_query_batch(queries, 100)
        print(f"[{tier}] k=100: route {m.last_route}, certified {m.last_certified:.6f}, redone "
              f"blocks {m.last_redone_blocks}", flush=True)
        _same_results(f"{tier} k=100", d100t, i100t, d100, i100)
        stagest, qenct = _breakdown(idx, queries, K, tier)
        print(f"[{tier} breakdown] device ms per stage: "
              + json.dumps({k: round(v, 4) for k, v in stagest.items()}), flush=True)
        tdata = m.data
        xtkt = (tdata.extra["pad"] + tdata.row_term).contiguous()
        qkt, qtkt = qenct["q"], qenct["q_term"].contiguous()
        # f32, reduced, reduced, f32 in turns; the means of each pair
        f32_run = lambda: GM.fused_groupmin(qkt, tdata.vecs, qtkt, xtkt, scale)  # noqa: E731
        new_run = lambda: GM.fused_groupmin(qkt, tdata.vecs, qtkt, xtkt, scale, precision=tier)  # noqa: E731
        t4 = [_cuda_ms(f32_run, 10), _cuda_ms(new_run, 10), _cuda_ms(new_run, 10), _cuda_ms(f32_run, 10)]
        mst, ms32 = (t4[1] + t4[2]) / 2, (t4[0] + t4[3]) / 2
        plain_mst = _cuda_ms(lambda: GM.fused_groupmin_reference(
            qkt, tdata.vecs, qtkt, xtkt, scale, precision=tier), 3)
        # the same kernel's output at these shapes: against its plain
        # version, and within the certificate's eps of the f32 kernel
        out = GM.fused_groupmin(qkt, tdata.vecs, qtkt, xtkt, scale, precision=tier)
        ref = GM.fused_groupmin_reference(qkt, tdata.vecs, qtkt, xtkt, scale, precision=tier)
        f32 = GM.fused_groupmin(qkt, tdata.vecs, qtkt, xtkt, scale)
        _, mag = _groupmin_bound(qkt, tdata.vecs, qtkt, xtkt, scale)
        diff = (out.double() - ref.double()).abs()
        rel = float((diff / mag).max())
        kernel_err[tier] = max(kernel_err[tier], float(diff.max()))
        eps = SS._pass1_eps(qkt, tdata, scale, tier).double()
        ratio = float(((out.double() - f32.double()).abs().amax(dim=1) / eps).max())
        bound_ms[tier] = _bound_ms(tier, qkt, tdata.vecs)
        print(f"[kernel] {tier} main-path shapes Q={qkt.shape[0]} N={tdata.vecs.shape[0]} "
              f"D={tdata.vecs.shape[1]}: kernel {mst:.3f} ms ({flops / mst / 1e9:.1f} TFLOP/s of the "
              f"f32 product), f32 kernel {ms32:.3f} ms, plain {plain_mst:.3f} ms; max |kernel - plain| "
              f"{float(diff.max()):.4g}, relative to the magnitude {rel:.3g} (limit 1e-5); max over "
              f"queries of max_g |kernel - f32 kernel| / eps {ratio:.3g}; bound {bound_ms[tier][0]:.3f} ms "
              f"({bound_ms[tier][1]}), {bound_ms[tier][0] / mst:.1%} of it; {smi}", flush=True)
        print(f"[kernel] {tier} against the f32 kernel in turns (f32, {tier}, {tier}, f32): "
              + ", ".join(f"{t:.3f}" for t in t4) + f" ms; ratio {mst / ms32:.3f} (the mma.sync kernel's "
              f"{OLD_RATIO[tier][1]}: {OLD_RATIO[tier][0]} / 13.294 ms, NVIDIA H100 80GB HBM3, 700 W)",
              flush=True)
        _require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                 lambda: f"{tier} kernel output not finite or not {tuple(ref.shape)} at the main path's shapes")
        _require(rel <= 1e-5, lambda: f"{tier} kernel vs plain at the main path's shapes: {rel} of the magnitude")
        _require(ratio <= 1.0, lambda: f"{tier} kernel beyond eps of the f32 kernel at the main path's shapes: {ratio}")
        tier_rec[tier] = {"launches": lt[tier], "ms": mst, "plain_ms": plain_mst, "f32_ms": ms32}
        del dt, it, d100t, i100t, tdata, qenct, qkt, qtkt, xtkt, out, ref, f32, mag, diff, eps
        torch.cuda.empty_cache()
    t0 = _phase("reduced tiers", t0)

    # ---- 8. forced fallback: row 5 copied into 39 other groups ----
    # Both failing queries lie in the first 256-query block, which re-runs
    # the f32 kernel. Under "high" the second block certifies, so its
    # reduced selection drives pass 2; "bfloat16" certifies fewer queries.
    base = corpus[:20000].copy()
    for g in range(1, 40):
        base[g * 128 + 7] = base[5]
    fq = queries[:512].copy()
    fq[10] = base[5] + 0.125
    fq[200] = base[5] + 0.25
    x_f = torch.from_numpy(base).to(dev)
    for tier in ("high", "bfloat16"):
        fidx = Index("l2", Params(dim=DIM), method="seq_search", device="cuda")
        fidx.add_dense_batch(base)
        fidx.build_index(Params(chunkSize=1024, pass1Precision=tier))
        GM.reset_launches()
        df, if_ = fidx.knn_query_batch(fq, K)
        lf = dict(GM.launches)
        m = fidx.method
        print(f"[fallback] {tier}: route {m.last_route}, certified {m.last_certified:.6f}, redone "
              f"blocks {m.last_redone_blocks} of 2, launches {lf}", flush=True)
        _require(m.last_route == "twopass" and m.last_redone_blocks > 0 and lf["float32"] > 0
                 and lf[tier] > 0, lambda: f"{tier}: the certificate did not fall back ({lf})")
        _require(tier != "high" or m.last_redone_blocks < 2, lambda: (
            "high: the second block did not certify, so no reduced selection reached pass 2"))
        _check_against_oracle(f"forced fallback {tier}", if_, df, torch.from_numpy(fq).to(dev), x_f, K)
    del x_f
    t0 = _phase("forced fallback", t0)

    # ---- 8b. gist-960's width end to end: the reduced tiers in K chunks ----
    from tpu_knn_torch.eval.datasets import sift_like

    wide = sift_like(20_096 + 256, 960, seed=3)
    wq = wide[20_096:]
    widx = Index("l2", Params(dim=960), method="seq_search", device="cuda")
    widx.add_dense_batch(wide[:20_096])
    dw, iw = widx.knn_query_batch(wq, K)
    _check_against_oracle("D=960 f32", iw, dw, torch.from_numpy(wq).to(dev),
                          torch.from_numpy(wide[:20_096]).to(dev), K)
    for tier in ("high", "bfloat16"):
        widx.build_index(Params(pass1Precision=tier))
        GM.reset_launches()
        dwt, iwt = widx.knn_query_batch(wq, K)
        lw = dict(GM.launches)
        print(f"[wide] {tier} D=960: route {widx.method.last_route}, certified "
              f"{widx.method.last_certified:.6f}, launches {lw}", flush=True)
        _require(widx.method.last_route == "twopass" and lw[tier] > 0,
                 lambda: f"D=960 {tier}: route {widx.method.last_route}, launches {lw}")
        _same_results(f"D=960 {tier} k={K}", dwt, iwt, dw, iw)
    del widx, wide
    t0 = _phase("gist-960 width", t0)

    # ---- 11 and 12. the scalar-product spaces at the glove-100-angular shape,
    # the gold standard and the metrics ----
    del idx
    torch.cuda.empty_cache()
    _phase_angular(smi)
    t0 = _phase("angular, gold standard and metrics", t0)

    # ---- 13. precision of the single-pass scan ----
    _phase_precision(corpus, queries, smi)
    t0 = _phase("precision", t0)

    # ---- 14. a NaN distance on the card ----
    _phase_nan(smi)
    t0 = _phase("nan", t0)

    # ---- 15. hnsw, the default method ----
    hn = _phase_hnsw(smi)
    t0 = _phase("hnsw", t0)
    print("[hnsw] " + json.dumps({"build_s": round(hn["build_s"], 2), "build_peak_gib": round(hn["build_peak_gib"], 3),
                                  "qps_recall": {str(ef): [round(r["qps"]), round(r["recall"], 4)]
                                                 for ef, r in hn["search"].items()}}) + f"; {smi}", flush=True)
    print("[async] " + json.dumps({"scan_1m": asy, "hnsw_100k": hn["async"]}) + f"; {smi}", flush=True)

    # ---- 16. nnd: the default index at SIFT-1M, built by NN-descent ----
    nd = _phase_nnd(smi, corpus, queries, i10)
    t0 = _phase("nnd", t0)
    print("[nnd] " + json.dumps({
        "build_s": nd["build_s"], "build_peak_gib": nd["peak_gib"], "phases": nd["phases"], "sweeps": nd["sweeps"],
        "repaired": nd["repaired"], "unreached": nd["unreached"],
        "qps_recall": {str(ef): [r["qps"], r["recall"]] for ef, r in nd["search"].items()},
        "side": nd["side"]}) + f"; {smi}", flush=True)

    # ---- 17. dense: the other dense spaces ----
    dn = _phase_dense(smi, corpus, queries)
    t0 = _phase("dense", t0)
    print("[dense] " + json.dumps(dn) + f"; {smi}", flush=True)

    # phases 18-20 run under a guard that counts the sparse scan's plain arithmetic on CUDA tensors
    # (every sparse space's scan, NAPP's and VP-tree's blocks, HNSW's wave mates launch the kernel
    # instead); the kernel step's comparisons with the plain version pause it
    with _PlainGuard(SPARSE_PLAIN) as sparse_guard:
        # ---- 18. sparse: the sparse spaces, exact scan and HNSW ----
        sn = _phase_sparse(smi)
        t0 = _phase("sparse", t0)
        print("[sparse] " + json.dumps({
            "scan_100k": sn["scan_100k"], "hnsw_default": sn["hnsw_default"], "scan_1m": sn["scan_1m"],
            "kernel": sn["kernel"], "side": sn["side"], "wave_profile": sn["wave_profile"], "r_ulp": sn["r_ulp"]},
            default=float) + f"; {smi}", flush=True)

        # ---- 19. bits, word_embed, NAPP and the inverted index ----
        torch.cuda.empty_cache()
        bt = _phase_bits(smi, corpus, queries)
        print("[bits] " + json.dumps(bt, default=float) + f"; {smi}", flush=True)
        em = _phase_embed(smi)
        print("[embed] " + json.dumps(em, default=float) + f"; {smi}", flush=True)
        na = _phase_napp(smi, corpus, queries, i10)
        print("[napp] " + json.dumps(na, default=float) + f"; {smi}", flush=True)
        t0 = _phase("bits, word_embed, napp", t0)

        # ---- 20. VP-tree, sw-graph, the string spaces, SQFD, fusion and dummy ----
        # (a) and (d) read phase 4's rows, so they run before the corpus is freed
        vt = _phase_vptree(smi, corpus, queries, i10, d10)
        print("[vptree] " + json.dumps(vt, default=float) + f"; {smi}", flush=True)
        sm = _phase_small(smi, corpus, queries)
        print("[sqfd] " + json.dumps(sm, default=float) + f"; {smi}", flush=True)
        t0 = _phase("vptree and the small names", t0)
        sg = _phase_swgraph(smi)
        print("[swgraph] " + json.dumps(sg, default=float) + f"; {smi}", flush=True)
        st = _phase_string(smi)
        print("[string] " + json.dumps(st, default=float) + f"; {smi}", flush=True)
        t0 = _phase("sw-graph and the string spaces", t0)
    print(f"[sparse] plain versions of the sparse scan called on CUDA tensors over phases 18-20: "
          f"{sparse_guard.count}", flush=True)
    _require(sparse_guard.count == 0, lambda: f"{sparse_guard.count} plain sparse-scan calls on the card")

    # ---- 21. the CLI and the mesh layer (phase 4's rows, then freed) ----
    torch.cuda.empty_cache()
    cl = _phase_cli(smi, corpus, queries)
    print("[cli] " + json.dumps(cl, default=float) + f"; {smi}", flush=True)
    t0 = _phase("cli", t0)
    ms_ = _phase_mesh(smi, corpus, queries, i10, d10)
    print("[mesh] " + json.dumps(ms_, default=float) + f"; {smi}", flush=True)
    del corpus, queries
    t0 = _phase("mesh", t0)

    # ---- 19 (e). the inverted index, after the 1M dense rows are freed ----
    iv = _phase_invindx(smi)
    print("[invindx] " + json.dumps(iv, default=float) + f"; {smi}", flush=True)
    t0 = _phase("invindx", t0)

    src_wgmma = "tpu_knn_torch/csrc/groupmin_wgmma.cu"
    rows = [
        ("groupmin_f32", "float32", "tpu_knn_torch/csrc/groupmin.cu", "tpu_knn/ops/pallas_scan.py:182",
         launches, max_abs_err, ms, plain_ms),
        ("groupmin_i8", "int8", "tpu_knn_torch/csrc/groupmin_wgmma_i8.cu", "tpu_knn/ops/pallas_scan.py:111",
         launches8["int8"], kernel_err["int8"], ms8, plain_ms8),
        ("groupmin_bf16x3", "high", src_wgmma, "tpu_knn/ops/pallas_scan.py:120", tier_rec["high"]["launches"],
         kernel_err["high"], tier_rec["high"]["ms"], tier_rec["high"]["plain_ms"]),
        ("groupmin_bf16", "bfloat16", src_wgmma, "tpu_knn/ops/pallas_scan.py:118",
         tier_rec["bfloat16"]["launches"], kernel_err["bfloat16"], tier_rec["bfloat16"]["ms"],
         tier_rec["bfloat16"]["plain_ms"]),
    ]
    # no single PyTorch call computes a group min, so no library time
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": n_launch,
         "max_abs_err": err, "ms": kms, "plain_ms": pms, "bound_ms": bound_ms[tier][0],
         "bound_by": bound_ms[tier][1], "library_ms": None}
        for name, tier, src, rep, n_launch, err, kms, pms in rows
    ]}
    # the elementwise kernel, each form and epilogue: the l1 and jsdivfast group mins at their
    # 1M cells' shapes, the batched epilogue at pass 2's and the heuristic pairs' shapes
    # (EW_BATCHED), the others at phase 17's 65,536-row check; launches from the run each row
    # names (EW_RECORD; lp at p=3 and, in rows of their own, at p=0.7); library_ms: torch.cdist's
    # distances (batched for the batched epilogue) for L1, LINF and LP
    replaces = {"groupmin": "tpu_knn/methods/seq_search.py:233 pass1_jnp (XLA fusion)",
                "dists": "tpu_knn/ops/distance.py:205 elementwise_blocked (XLA fusion)",
                "batched": "tpu_knn/ops/graph.py:152 score_gathered, tpu_knn/methods/hnsw.py:78 _score_pairs "
                           "(jax.vmap of space.block, XLA fusion)"}
    for key, r in dn["ew_record"].items():
        record["kernels"].append({
            "name": key, "route": "cuda", "source": "tpu_knn_torch/csrc/groupmin_elementwise.cu",
            "replaces": replaces[key.split("_")[1]], "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    # the sparse scan's kernel over the 1M cell's whole corpus (its 246 launches of one scan; ms its
    # device time where the profiler traced it); library_ms: torch.sparse.mm of the dots alone over
    # the same rows
    sq = sn["kernel"]["1m"]
    record["kernels"].append({
        "name": "sparse_qdense", "route": "cuda", "source": "tpu_knn_torch/csrc/sparse_qdense.cu",
        "replaces": "tpu_knn/ops/sparse.py:128 dot_qdense, :149 intersect_count_qdense (XLA gather + einsum)",
        "launches": sn["scan_1m"]["launches"],
        "max_abs_err": max(sq["max_abs_err"], sn["kernel"]["config5"]["max_abs_err"],
                           sn["kernel"]["dense"]["max_abs_err"], sn["kernel"]["sweep"]["max_abs_err"]),
        "ms": sq["full_device_ms"] or sq["full_ms"], "plain_ms": sq["full_plain_ms"], "bound_ms": sq["full_bound_ms"],
        "bound_by": sq["full_bound_by"], "library_ms": sn["scan_1m"]["library_ms"]})
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
