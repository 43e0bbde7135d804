"""Field training (reference train.py); so far only the summary writer
that the ID-module trainer shares with it."""

from __future__ import annotations


def make_summary_writer(logfolder: str):
    """TensorBoard writer (reference train.py:157); a no-op writer when
    tensorboard does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(logfolder)
    except ImportError:
        class _Null:
            def add_scalar(self, *a, **k):
                pass

            def close(self):
                pass

        return _Null()
