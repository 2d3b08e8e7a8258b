"""Plain reference of ``cnn14rnn_trm``: the reference's Clotho recipe
``eg_configs/clotho_v2/waveform/cnn14rnn_trm.yaml``.  A 32 kHz log-mel
(slaney scale and norm, f_min 50, f_max 14 kHz, no floor); PANNs Cnn14
(batch norm over the mel bins, six double 3x3 convolution blocks 64 ->
2048 with 2x2 average pooling after all but the last, the mel mean), its
output detached and the Cnn14 in eval mode (``freeze_cnn``,
``freeze_cnn_bn``); a 3-layer bidirectional GRU of 256 over each clip's
valid frames (frames // 32); a 2-layer transformer decoder, width 256,
untied.  Parameter names are the reference's."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from reference.common import Mel, TransformerDecoder, log_mel

MEL = Mel(sample_rate=32000, n_fft=1024, hop=320, n_mels=64, f_min=50.0,
          f_max=14000.0, norm="slaney", mel_scale="slaney", top_db=None)
CHANNELS = (64, 128, 256, 512, 1024, 2048)


class ConvBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn1, self.bn2 = nn.BatchNorm2d(cout), nn.BatchNorm2d(cout)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class Cnn14(nn.Module):
    def __init__(self):
        super().__init__()
        self.bn0 = nn.BatchNorm2d(64)
        for i, (cin, cout) in enumerate(zip((1,) + CHANNELS[:-1], CHANNELS)):
            setattr(self, f"conv_block{i + 1}", ConvBlock(cin, cout))
        # PANNs' embedding layer: in the checkpoint, unused by the captioner
        self.fc1 = nn.Linear(2048, 2048)

    def forward(self, lms, frames):
        x = self.bn0(lms.transpose(1, 2)[..., None])[..., 0]   # over mels
        x = x.transpose(1, 2)[:, None]                          # [B,1,T,M]
        for i in range(6):
            x = getattr(self, f"conv_block{i + 1}")(x)
            if i < 5:
                x = F.avg_pool2d(x, 2)
        return x.mean(dim=3).transpose(1, 2), frames // 32


class BiGru(nn.Module):
    """Dropout at ``p`` on every layer's output but the last, in
    ``train()``: cuDNN's on the card, whose masks follow the default
    generator's seed."""

    def __init__(self, d_in, hidden, layers, p):
        super().__init__()
        self.network = nn.GRU(d_in, hidden, layers, batch_first=True,
                              bidirectional=True, dropout=p)

    def forward(self, x, lens):
        T = x.shape[1]
        packed = pack_padded_sequence(x, lens.cpu().clamp(1, T),
                                      batch_first=True, enforce_sorted=False)
        out, _ = pad_packed_sequence(self.network(packed)[0],
                                     batch_first=True, total_length=T)
        return out


class Encoder(nn.Module):
    def __init__(self, hidden, layers, p):
        super().__init__()
        self.cnn = Cnn14()
        self.rnn = BiGru(2048, hidden, layers, p)

    def forward(self, lms, frames):
        with torch.no_grad():
            self.cnn.eval()
            x, lens = self.cnn(lms, frames)
        return self.rnn(x, lens), lens


class Captioner(nn.Module):
    mel = MEL

    def __init__(self, config: Dict):
        super().__init__()
        self.encoder = Encoder(config["rnn_hidden_size"],
                               config["rnn_num_layers"],
                               config["rnn_dropout"])
        self.decoder = TransformerDecoder(
            config["decoder_emb_dim"], config["vocab_size"],
            2 * config["rnn_hidden_size"], config["decoder_n_layers"],
            config["decoder_tie_weights"], config["decoder_dropout"])

    def fixed(self) -> Dict[str, torch.Tensor]:
        return self.decoder.fixed("decoder.")

    def features(self, wav: torch.Tensor, wav_len: torch.Tensor):
        """-> (the encoder's output [B, S, 512], its lengths [B])."""
        with torch.no_grad():
            lms = log_mel(wav, MEL)
        return self.encoder(lms, MEL.frames(wav_len))

    def encode(self, wav: torch.Tensor, wav_len: torch.Tensor):
        """-> (memory [B, S, d], memory mask [B, S], True = padding)."""
        return self.decoder.memory(*self.features(wav, wav_len))
