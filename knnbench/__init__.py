"""knnbench: the benchmark of tpu_knn_torch, the PyTorch and CUDA port of
tpu_knn, on NVIDIA H100 cards. ``python -m knnbench --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell once; README.md
says what the files are."""
