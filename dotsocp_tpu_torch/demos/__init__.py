"""The demos of the JAX package (``demos/``) on the port: run as
``python -m dotsocp_tpu_torch.demos.demo_dot2d ...`` with the same flags
and defaults. They run on the card; ``--cpu`` runs them on the CPU. Each
module's ``main(argv=None)`` returns its solve's result."""
