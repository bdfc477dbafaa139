from percivaltts_tpu_torch.training.state import GANState, make_gan_state  # noqa: F401
from percivaltts_tpu_torch.training.lse import lse_step  # noqa: F401
from percivaltts_tpu_torch.training.wgan import make_wgan_step  # noqa: F401
from percivaltts_tpu_torch.training.loop import Trainer  # noqa: F401
