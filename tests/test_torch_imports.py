"""The port stands alone: no JAX, nothing of the JAX package, and no silent
CPU fallback from its entry points."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "omni_recall_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"))
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax"), f"{path}: imports {name}"
        assert top != "omni_recall_tpu", f"{path}: imports {name}"
        assert top != "bench", f"{path}: imports {name}"


def test_engine_and_server_import_without_jax():
    code = (
        "import sys\n"
        "import omni_recall_tpu_torch.search.engine\n"
        "import omni_recall_tpu_torch.server.app\n"
        "import omni_recall_tpu_torch.server.__main__\n"
        "import omni_recall_tpu_torch.models.encoder\n"
        "import omni_recall_tpu_torch.ingest.embedding\n"
        "import omni_recall_tpu_torch.chat\n"
        "import omni_recall_tpu_torch.extract.ocr\n"
        "import omni_recall_tpu_torch.server.openapi\n"
        "import omni_recall_tpu_torch.server.ui\n"
        "import omni_recall_tpu_torch.tools.probe_rebuild\n"
        "import omni_recall_tpu_torch.tools.sweep_10m\n"
        "import omni_recall_tpu_torch.tools.bench_ingest\n"
        "import omni_recall_tpu_torch.models.finetune\n"
        "import omni_recall_tpu_torch.models.decoder\n"
        "import omni_recall_tpu_torch.chat.serving\n"
        "import omni_recall_tpu_torch.chat.local\n"
        "import omni_recall_tpu_torch.tools.localq\n"
        "import omni_recall_tpu_torch.tools.probe_localq\n"
        "import omni_recall_tpu_torch.tools.train_embedder_demo\n"
        "import omni_recall_tpu_torch.tools.train_chat_demo\n"
        "import omni_recall_tpu_torch.tools.bench_decode\n"
        "import omni_recall_tpu_torch.parallel\n"
        "import omni_recall_tpu_torch.parallel.distributed\n"
        "import omni_recall_tpu_torch.tools.sharded_check\n"
        "import omni_recall_tpu_torch.tools.probe_sharded_timing\n"
        "import omni_recall_tpu_torch.utils.profiling\n"
        "import omni_recall_tpu_torch.eval.__main__\n"
        "import omni_recall_tpu_torch.eval.clients\n"
        "import omni_recall_tpu_torch.eval.quality\n"
        "import omni_recall_tpu_torch.eval.real_corpus\n"
        "import omni_recall_tpu_torch.tools.quality_real_corpus\n"
        "import omni_recall_tpu_torch.tools.profile_int8\n"
        "import omni_recall_tpu_torch.tools.sweep_coarse\n"
        "import omni_recall_tpu_torch.tools.probe_scan_decomp\n"
        "import omni_recall_tpu_torch.tools.profile_refine\n"
        "import omni_recall_tpu_torch.tools.probe_direct_serve\n"
        "import omni_recall_tpu_torch.tools.probe_gather_sorted\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'omni_recall_tpu.'))"
        " or m == 'omni_recall_tpu']\n"
        "assert not bad, bad\n"
    )
    # -S: no site hooks, so nothing is imported on the port's behalf
    env_path = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-S", "-c", f"import sys; sys.path[:0] = {[env_path] + [p for p in sys.path if 'site-packages' in p or 'dist-packages' in p]!r}\n" + code],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from omni_recall_tpu_torch.config import EngineOptions
    from omni_recall_tpu_torch.index.device_index import DeviceIndex
    from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
    from omni_recall_tpu_torch.search.engine import RecallEngine
    from omni_recall_tpu_torch.server.app import build_app
    from omni_recall_tpu_torch.config import load_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceIndex(32)
    with pytest.raises(RuntimeError, match="CUDA"):
        RecallEngine(InMemoryIngestionStore(), options=EngineOptions(embedding_dim=32))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_app(load_config(settings_file=None, env={}))
    from omni_recall_tpu_torch.parallel.mesh import shards_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        shards_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_app(load_config(settings_file=None, env={}, overrides={"Engine:Shards": 2}))
    from omni_recall_tpu_torch.chat.local import LocalDecoderChatClient
    from omni_recall_tpu_torch.models import decoder, encoder, finetune

    small = encoder.EncoderConfig(vocab_size=64, d_model=8, n_layers=1, n_heads=2, d_ff=8,
                                  max_len=8, out_dim=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        finetune.inverse_cloze_finetune(["a b c"], small, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        encoder.trainable(encoder.init_params(0, small))
    tiny = decoder.DecoderConfig(d_model=8, n_layers=1, n_heads=2, d_ff=8, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalDecoderChatClient(cfg=tiny, params=decoder.init_params(0, tiny))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_app(load_config(settings_file=None, env={}, overrides={
            "Ai:Provider": "Local", "Ai:LocalWarmup": "false", "Engine:Backend": "oracle"}))
    # asked for explicitly, the CPU works
    assert DeviceIndex(32, device="cpu").device.type == "cpu"
    eng = RecallEngine(InMemoryIngestionStore(),
                       options=EngineOptions(embedding_dim=32), device="cpu")
    assert eng.device_index.device.type == "cpu"


def test_kernel_wrappers_do_not_fall_back_for_other_devices():
    """A wrapper takes its plain version only for CPU tensors."""
    from omni_recall_tpu_torch.ops import scorer

    emb8 = torch.zeros((256, 32), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        scorer.block_topt_int8_coarse(
            emb8, emb8[:4], torch.zeros((1, 256), device="meta"),
            torch.zeros((1, 256), device="meta"), torch.zeros((4, 1), device="meta"),
            torch.zeros((4, 1), device="meta"), t=2, sub=128)
    emb = torch.zeros((256, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        scorer.block_topt(
            emb, torch.zeros((256, 4), dtype=torch.uint8, device="meta"), emb[:4],
            torch.zeros((4, 32), device="meta"), torch.zeros((4, 1), device="meta"),
            torch.zeros((1, 256), device="meta"), t=2, sub=128)
