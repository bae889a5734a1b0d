from sunet_tf_tpu_torch.utils.augment import MixUp, gaussian_blur, gaussian_blur_kernel  # noqa: F401
from sunet_tf_tpu_torch.utils.cache import enable_kernel_cache  # noqa: F401
from sunet_tf_tpu_torch.utils.color import hsl2rgb, hsv2rgb, rgb2hsl, rgb2hsv  # noqa: F401
from sunet_tf_tpu_torch.utils.dirs import get_last_path, mkdir, mkdirs  # noqa: F401
from sunet_tf_tpu_torch.utils.freeze import freeze_mask, partition_trainable  # noqa: F401
