"""Evaluation: baseline policies and Learned-vs-Baseline combinations
(port of ``vit_marl_tpu/eval``)."""
