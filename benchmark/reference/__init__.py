"""Plain PyTorch reference of what the benchmark's cells ask of the program.

It works out again, from the sensed states the window's controller was
given, what the program's controller had to answer: the obstacle grid, the
dense jerk-limited lattice DP, the trim, the ADMM smoother and the
first-step speed command (``planner``), and for the combined cells the
RL+MPC arbiter (``arbiter``).  It also holds the ego's update rule and the
start-speed draw of the world (``world``), which the check uses on the
states that follow a command.

Every module here is a frozen copy of the semantics of the paper's code
(jlubars/RL-MPC-LaneMerging: st.py, st_cy.pyx, prediction.py, dqn.py,
control.py) in plain torch operations.  Nothing here imports the program,
JAX or the JAX package, and nothing takes a tensor the program derived:
the inputs are the sensed states and the configuration's numbers.
"""
