"""⟦«py»/models/lenet/lenet5.py⟧ — build_model + the training main."""
from bigdl_tpu_torch.models.lenet import (build_lenet5, main,  # noqa: F401
                                          train_lenet)


def build_model(class_num: int = 10, device="cuda"):
    """Reference spelling (lenet5.build_model), on ``device``."""
    return build_lenet5(class_num=class_num, device=device)
