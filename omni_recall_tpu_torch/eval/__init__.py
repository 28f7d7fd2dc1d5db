from omni_recall_tpu_torch.eval.harness import EvalHarness, EvalCase  # noqa: F401
