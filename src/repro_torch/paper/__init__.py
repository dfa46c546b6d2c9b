"""The paper's own evaluation on the port (counterparts of the repo-root
``benchmarks/`` modules of the same names): Table 1, the convolution-error
equations, Tables 2-4, Figs. 7-10 and Table 5.  Each module's ``run()``
returns the reference's rows; ``python -m repro_torch.paper.run`` prints
them."""
