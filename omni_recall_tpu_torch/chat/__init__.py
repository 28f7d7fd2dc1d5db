from omni_recall_tpu_torch.chat.router import (  # noqa: F401
    AiChatRouter,
    AiProviderUnavailableError,
    AiRateLimitError,
    HttpRequestError,
)
from omni_recall_tpu_torch.chat.orchestration import ChatOrchestrationService  # noqa: F401
