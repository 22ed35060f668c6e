"""The training path and the host-side supervision it shares with the services:
the optimizer (``optimizer``), the train, serve and prefill step builders
(``step``), checkpoints (``checkpoint``), the synthetic data stream (``data``),
and straggler detection, heartbeats and bounded retries (``fault``)."""
