"""Transport (diffusion / flow) encoder-processor-decoder.

Port of ``anemoi_tpu.models.transport_model``
(``AnemoiTransportModelEncProcDec``, ``AnemoiTransportTendModelEncProcDec``):
the network learns a denoiser (EDM) or a velocity field (stochastic
interpolant) for the next state, conditioned on the input window.

The (scaled) noised target ``y_noised [B, T_out, E, G, V_out]`` is
concatenated to the input window's features at the encoder; the noise level
or time ``noise_level [B, E]`` enters through a time embedding
(``noise_embedding``: ``fourier``, ``random_fourier``, ``sinusoidal``), cast
to the compute type, which conditions every norm of the processor
(``processor.conditional``, default true here) and, with
``conditional_mappers`` (default: whether ``noise_channels`` is set), of the
graph-transformer mappers.  With ``noise_channels`` the embedding runs at
that width and ``noise_cond_mlp`` (Linear, SiLU, Linear; anemoi-core's
``linear1_no_gradscaling`` / ``linear2_no_gradscaling``) projects it to
``noise_cond_dim``.  The conditioning is one row per sample, ``[B·E, 1,
C]``, broadcast over the nodes by the norms.  The EDM skip/out combination
lives in the objective, so the model returns the raw network output: no
residual connection and no boundings, as in the JAX model.  Under model
shards (``edges`` or ``heads``) it runs on the rank's grid and hidden rows
as the flat model does; its conditioning is one row per sample, so it
needs no padding.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from anemoi_tpu_torch.models.encoder_processor_decoder import AnemoiModelEncProcDec
from anemoi_tpu_torch.models.transport.objectives import TIME_EMBEDDINGS


class NoiseConditioningMLP(nn.Module):
    """Linear -> SiLU -> Linear over the noise embedding."""

    def __init__(self, channels: int, out_channels: int) -> None:
        super().__init__()
        self.linear1_no_gradscaling = nn.Linear(channels, channels)
        self.linear2_no_gradscaling = nn.Linear(channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2_no_gradscaling(nn.functional.silu(self.linear1_no_gradscaling(x)))


class AnemoiTransportModelEncProcDec(AnemoiModelEncProcDec):
    """Denoiser / velocity network over the grid -> mesh -> grid model."""

    is_transport = True
    runtime_edges = False  # the JAX transport model keeps the static edges

    def __init__(self, *, graph, data_indices, config: dict, statistics=None) -> None:
        super().__init__(graph=graph, data_indices=data_indices, config=config,
                         statistics=statistics)
        # the raw network output: the JAX model has neither
        del self.residual, self.boundings
        if self.noise_channels is not None:
            self.noise_cond_mlp = NoiseConditioningMLP(self.noise_channels, self.noise_cond_dim)

    @property
    def noise_embed_dim(self) -> int:
        return int(self.config.get("noise_embed_dim", 16))

    @property
    def noise_channels(self) -> Optional[int]:
        v = self.config.get("noise_channels")
        return None if v is None else int(v)

    @property
    def noise_cond_dim(self) -> int:
        v = self.config.get("noise_cond_dim")
        return self.noise_embed_dim if v is None else int(v)

    @property
    def conditional_mappers(self) -> bool:
        return bool(self.config.get("conditional_mappers", self.noise_channels is not None))

    def _processor_conditional(self) -> bool:
        return bool((self.config["processor"] or {}).get("conditional", True))

    def _conditioning_dim(self) -> int:
        return self.noise_cond_dim

    def _mapper_conditioning_dim(self) -> Optional[int]:
        return self.noise_cond_dim if self.conditional_mappers else None

    def input_dim(self, ds: str, trainable: dict) -> int:
        return super().input_dim(ds, trainable) + (
            self.n_step_output * self.data_indices[ds].num_model_output_vars)

    def _conditioning(self, noise_level: torch.Tensor, bflat: int, dt: torch.dtype):
        embed_fn = TIME_EMBEDDINGS[self.config.get("noise_embedding", "fourier")]
        level = noise_level.reshape(bflat)
        if self.noise_channels is None:
            return embed_fn(level, self.noise_embed_dim).to(dt)
        kw = {}
        if self.config.get("noise_max_period") is not None:
            kw["max_period"] = float(self.config["noise_max_period"])
        return self.noise_cond_mlp(embed_fn(level, self.noise_channels, **kw).to(dt))

    def forward(self, x: Dict[str, torch.Tensor], y_noised: Optional[Dict[str, torch.Tensor]] = None,
                noise_level: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """x[ds]: the conditioning window ``[B, T_in, E, G, V_in]`` in the
        compute type; ``y_noised[ds]``: the (c_in-scaled) noised target
        ``[B, T_out, E, G, V_out]``, every dataset of ``x``; ``noise_level``:
        ``[B, E]`` (EDM's c_noise or the interpolant's t).  Returns
        ``{ds: [B, T_out, E, G, V_out]}``."""
        if y_noised is None or noise_level is None:
            raise ValueError("a transport model takes the noised target (y_noised) and its "
                             "noise level (noise_level)")
        graph = self.graph
        hidden = graph.hidden_name
        datasets = sorted(x)
        missing = [ds for ds in datasets if ds not in y_noised]
        if missing:
            raise ValueError(f"a transport model needs the noised target of every dataset; "
                             f"missing {missing}")
        some = x[datasets[0]]
        batch, n_time, ens = some.shape[:3]
        if n_time != self.n_step_input:
            raise ValueError(f"Expected {self.n_step_input} input steps, got {n_time}")
        bflat = batch * ens
        dt = some.dtype

        cond_vec = self._conditioning(noise_level, bflat, dt)[:, None, :]  # [B·E, 1, C]
        cond_mappers = cond_vec if self.conditional_mappers else None
        hidden_attrs = self.node_attributes(hidden, graph.node_features[hidden].to(dt))
        hidden_attrs = hidden_attrs[self.hidden_rows()]
        x_hidden_latent = hidden_attrs[None].expand((bflat,) + hidden_attrs.shape)

        x_data_latent, latents = {}, []
        for ds in datasets:
            xd, yn = x[ds], y_noised[ds]
            node_attrs = self.node_attributes(ds, graph.node_features[ds].to(dt))
            node_attrs = node_attrs[self.grid_rows(ds)]
            flat_x = xd.permute(0, 2, 3, 1, 4).reshape(bflat, xd.shape[3], n_time * xd.shape[4])
            flat_y = yn.permute(0, 2, 3, 1, 4).reshape(bflat, yn.shape[3],
                                                       yn.shape[1] * yn.shape[4])
            x_latent_in = torch.cat(
                [flat_x, flat_y.to(dt), node_attrs[None].expand((bflat,) + node_attrs.shape)],
                dim=-1)
            sub = graph.encoder[ds]
            cond = None if cond_mappers is None else (cond_mappers, cond_mappers)
            x_data_latent[ds], x_latent = self.encoder[ds](
                (x_latent_in, x_hidden_latent), self._set("encoder", ds),
                self._edges("encoder_graph_provider", sub, ds), cond)
            latents.append(x_latent)

        x_latent = sum(latents)
        x_latent_proc = self._run_processor(x_latent, cond_vec)
        if self.latent_skip:
            x_latent_proc = x_latent_proc + x_latent

        out = {}
        for ds in datasets:
            sub = graph.decoder[ds]
            cond = None if cond_mappers is None else (cond_mappers, cond_mappers)
            x_out = self.decoder[ds](
                (x_latent_proc, x_data_latent[ds]), self._set("decoder", ds),
                self._edges("decoder_graph_provider", sub, ds), cond)
            out[ds] = x_out.reshape(batch, ens, x_out.shape[1], self.n_step_output,
                                    self.data_indices[ds].num_model_output_vars
                                    ).permute(0, 3, 1, 2, 4)
        return out


class AnemoiTransportTendModelEncProcDec(AnemoiTransportModelEncProcDec):
    """The tendency variant: the sampled quantity is the state increment.
    The training step and the forecast compute the tendency targets; the
    network is the same."""
