"""Host-side supervision utilities shared by the port's services (``fault``), the
synthetic data stream (``data``) and the serve and prefill step builders (``step``)."""
