from percivaltts_tpu_torch.models.generators import (  # noqa: F401
    BLSTMGenerator,
    CNNGenerator,
    FCGenerator,
    build_generator,
)
from percivaltts_tpu_torch.models.critic import (  # noqa: F401
    Critic,
    build_critic,
)
from percivaltts_tpu_torch.models.base import (  # noqa: F401
    count_params,
    predict_batch,
    predict_utterance,
)
