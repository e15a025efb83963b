"""Post-hoc TensorBoard run analysis.

A copy of ``intro_tc_vae_tpu/utils/tb_reader.py`` (parity surface of
reference tb_reader.py:13-194): locate a run directory by hparam
fingerprint regex, parse the hparams protobuf, expose typed accessors for
every score/loss family the solvers write, and extract logged
reconstruction images. It reads what either package's writer writes
(``torch.utils.tensorboard`` or tensorboardX: ``add_scalars`` families in
``{main}_{sub}/`` sub-runs, ``add_hparams`` in a sub-run named by its
time stamp). ``tensorboard``, pandas and PIL are imported where they are
used. One change: ``get_reader`` also finds the runs the trainers name,
``..._{beta_kl}_{beta_neg}_{beta_rec}_{gamma_r}_{arch}_...``
(``Config.run_comment``), where the JAX regex wants the arch first.
"""

from __future__ import annotations

import glob
import io
import os
import re
from pathlib import Path
from typing import List


class TagConverter:
    """Wraps an EventAccumulator for one (sub-)run directory
    (reference tb_reader.py:13-46)."""

    SIZE_GUIDANCE = {
        "compressedHistograms": 500,
        "images": 4,
        "audio": 4,
        "scalars": 10000,
        "histograms": 1,
        "tensors": 10,
    }

    def __init__(self, tag_path: Path, events_file: str | None = None):
        from tensorboard.backend.event_processing import event_accumulator

        self.tag_path = Path(tag_path)
        if events_file is None:
            events_file = os.listdir(str(self.tag_path))[0]
        self.events_file = self.tag_path / events_file
        self.ea = event_accumulator.EventAccumulator(
            str(self.events_file),
            size_guidance={
                event_accumulator.COMPRESSED_HISTOGRAMS: 500,
                event_accumulator.IMAGES: 4,
                event_accumulator.AUDIO: 4,
                event_accumulator.SCALARS: 10000,
                event_accumulator.HISTOGRAMS: 1,
                event_accumulator.TENSORS: 10,
            },
        )
        self.ea.Reload()

    @property
    def scalar_tags(self) -> List[str]:
        return self.ea.Tags()["scalars"]

    def get_df(self, tag: str):
        import pandas as pd

        return pd.DataFrame(self.ea.Scalars(tag))

    @property
    def exists(self) -> bool:
        return self.events_file.exists()

    @property
    def name(self) -> str:
        return self.tag_path.name


class TensorboardReader:
    """Typed accessors over one training run's TB logs
    (reference tb_reader.py:48-194)."""

    def __init__(self, run_dir: str, run: str):
        self.run_path = Path(run_dir).resolve() / run
        self._base_event = None

    # -- discovery --------------------------------------------------------

    @staticmethod
    def match_first(directory: str, pattern: str, regex: bool = False) -> Path:
        p = Path(directory).resolve()
        if regex:
            return [x for x in p.iterdir() if re.search(pattern, x.name)][0]
        return Path(glob.glob(str(p / pattern))[0])

    @staticmethod
    def match_name(directory: str, pattern: str, regex: bool = False) -> str:
        return TensorboardReader.match_first(directory, pattern, regex).name

    @classmethod
    def get_reader(cls, directory: str, arch: str, beta_kl, beta_neg, beta_rec, gamma_r):
        """Find a run by its hparam fingerprint (reference tb_reader.py:72-75):
        the four betas in order and the arch before or after them."""
        betas = ".*".join(f"_{re.escape(str(b))}"
                          for b in (beta_kl, beta_neg, beta_rec, gamma_r))
        s = f"^(?=.*_{re.escape(str(arch))}).*{betas}.*"
        run = cls.match_first(directory, s, regex=True)
        return cls(directory, run.name)

    @property
    def exists(self) -> bool:
        return self.run_path.exists()

    # -- events -----------------------------------------------------------

    @property
    def base_event(self) -> TagConverter:
        if self._base_event is None:
            f = self.match_name(self.run_path, "events.out.*")
            self._base_event = self.read_score("", events_file=f)
        return self._base_event

    def read_score(self, name: str, events_file: str | None = None) -> TagConverter:
        return TagConverter(self.run_path / name, events_file=events_file)

    def _score_df(self, main: str, sub: str):
        """add_scalars sub-run accessor, tolerant of both writer layouts:
        torch SummaryWriter writes '{main}_{sub}/', tensorboardX writes
        '{main}/{sub}/'."""
        flat = self.run_path / f"{main}_{sub}"
        nested = self.run_path / main / sub
        path = flat if flat.is_dir() else nested
        return TagConverter(path).get_df(main)

    # -- tc_decomp (reference solvers/tc.py:129-139, quirk Q11) -----------

    @property
    def tc_decomp_mi(self):
        return self._score_df("tc_decomp", "mi")

    @property
    def tc_decomp_tc(self):
        return self._score_df("tc_decomp", "tc")

    @property
    def tc_decomp_kl(self):
        return self._score_df("tc_decomp", "kl")

    # -- hparams ----------------------------------------------------------

    @property
    def hparams(self):
        """(hparam dict, metric dict) from the hparams plugin protobuf."""
        from tensorboard.plugins.hparams.plugin_data_pb2 import HParamsPluginData

        ssi_tag = "_hparams_/session_start_info"
        # hparams sub-run dir is named str(time.time()) -> starts with 1
        hp_dir = self.match_name(self.run_path, "1*")
        score = self.read_score(
            hp_dir, events_file=self.match_name(self.run_path / hp_dir, "events.out*")
        )
        content = score.ea.PluginTagToContent("hparams")
        plugin_data = HParamsPluginData.FromString(content[ssi_tag])
        hparam_dict = dict(plugin_data.session_start_info.hparams)
        metric_dict = {t: score.get_df(t)["value"][0] for t in score.scalar_tags}
        return hparam_dict, metric_dict

    # -- scores -----------------------------------------------------------

    @property
    def bvae_score(self):
        return self._score_df("bvae_score", "score")

    @property
    def bvae_score_scaled(self):
        return self._score_df("bvae_score", "scaled")

    @property
    def explicitness_score(self):
        return self._score_df("mod_expl", "explicitness_score")

    @property
    def modularity_score(self):
        return self._score_df("mod_expl", "modularity_score")

    @property
    def mig_score(self):
        return self.base_event.get_df("mig_score")

    @property
    def dci_completeness_score(self):
        return self._score_df("dci", "dci_completeness_score")

    @property
    def dci_disentanglement_score(self):
        return self._score_df("dci", "dci_disentanglement_score")

    @property
    def dci_informativeness_score(self):
        return self._score_df("dci", "dci_informativeness_score")

    # -- losses -----------------------------------------------------------

    @property
    def r_loss_scaled(self):
        return self._score_df("losses", "r_loss")

    @property
    def r_loss(self):
        return self.base_event.get_df("r_loss_unscaled")

    @property
    def kl_loss_scaled(self):
        return self._score_df("losses", "kl_loss")

    @property
    def kl_loss(self):
        return self.base_event.get_df("kl_loss_unscaled")

    @property
    def expelbo_f_loss_scaled(self):
        return self._score_df("losses", "expelbo_f")

    @property
    def diff_kl(self):
        return self.base_event.get_df("diff_kl")

    @property
    def loss_e(self):
        return self.base_event.get_df("lossE")

    @property
    def loss_d(self):
        return self.base_event.get_df("lossD")

    # -- images -----------------------------------------------------------

    @property
    def reconstructions(self) -> List:
        return self.base_event.ea.Images("reconstructions")

    def get_reconstruction_image(self, idx: int):
        from PIL import Image

        image = self.reconstructions[idx]
        return Image.open(io.BytesIO(image.encoded_image_string))

    @property
    def last_reconstruction(self):
        return self.get_reconstruction_image(-1)
