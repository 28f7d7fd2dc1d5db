from omni_recall_tpu_torch.server.app import OmniRecallApp, build_app  # noqa: F401
from omni_recall_tpu_torch.server.testing import TestClient  # noqa: F401
