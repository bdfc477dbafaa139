from percivaltts_tpu_torch.vocoders.base import Vocoder, get_vocoder  # noqa: F401
from percivaltts_tpu_torch.vocoders.melspec import MelSpecVocoder  # noqa: F401
from percivaltts_tpu_torch.vocoders.pml import PMLVocoder  # noqa: F401
from percivaltts_tpu_torch.vocoders.world import WorldVocoder  # noqa: F401
