"""TensorBoard writing + the global writer singleton.

Counterpart of ``intro_tc_vae_tpu/utils/writer.py`` (parity surface of
reference utils.py:62-74, the SingletonWriter holding the writer /
cur_iter / test_iter globals, and train.py:94-103, the run naming). The
writer is ``torch.utils.tensorboard.SummaryWriter``, or tensorboardX's
where that does not import; either is imported when a writer is made,
never at import.
"""

from __future__ import annotations

from typing import Optional


class SingletonWriter:
    """Process-global writer handle (reference utils.py:62-74)."""

    writer = None
    cur_iter: int = 0
    test_iter: int = 1000

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    @property
    def write_test_iter(self) -> bool:
        return bool(self.writer) and self.cur_iter % self.test_iter == 0


def _summary_writer_class():
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as torch_err:
        try:
            from tensorboardX import SummaryWriter
        except ImportError as tbx_err:
            raise ImportError(
                "use_tensorboard needs torch.utils.tensorboard (the tensorboard "
                f"package; {torch_err}) or tensorboardX ({tbx_err})"
            ) from tbx_err
    return SummaryWriter


def make_writer(comment: str = "", log_dir: Optional[str] = None):
    """A SummaryWriter in ``log_dir + comment``, or, without ``log_dir``, in
    the writer's default ``runs/<time>_<host><comment>``."""
    summary_writer = _summary_writer_class()
    if log_dir:
        return summary_writer(log_dir=log_dir + comment)
    return summary_writer(comment=comment)
