"""Host-side input pipelines: transforms, data modules and the prefetcher."""

from .datamodules import (  # noqa: F401
    DATASET_NUM_CLASSES,
    ArrayDataModule,
    DataModule,
    EuroSATDataModule,
    FolderDataModule,
    GTOSMobileDataModule,
    MSTARDataModule,
    PlantVillageDataModule,
    RESISC45DataModule,
    SugarcaneDamageUSADataModule,
    SyntheticDataModule,
    UCMercedDataModule,
    get_datamodule,
)
from .prefetch import prefetch, to_device  # noqa: F401
from .transforms import (  # noqa: F401
    IMAGENET_MEAN,
    IMAGENET_STD,
    TransformConfig,
    eval_transform,
    to_float01,
    train_transform,
)
