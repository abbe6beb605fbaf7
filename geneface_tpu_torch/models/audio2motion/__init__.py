from geneface_tpu_torch.models.audio2motion.discriminators import (  # noqa: F401
    CosineDiscriminator1DFactory,
    Discriminator,
    Discriminator1DFactory,
    MultiWindowDiscriminator,
)
from geneface_tpu_torch.models.audio2motion.flow import (  # noqa: F401
    WN,
    ActNorm,
    CouplingBlock,
    Flip,
    Glow,
    InvConvNear,
    ResidualCouplingBlock,
    ResidualCouplingLayer,
)
from geneface_tpu_torch.models.audio2motion.vae import (  # noqa: F401
    FVAE,
    FVAEDecoder,
    FVAEEncoder,
    PitchContourVAEModel,
    VAEModel,
)
