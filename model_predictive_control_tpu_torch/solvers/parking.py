"""Session-4 parking OCP weights (port of the constants of
``solvers/parking.py``; the OCP builders and controllers come with the
AL-iLQR/SQP slice, ROADMAP S3.2)."""

# main.py:72-74 of the reference
Q_MAIN = (1.0, 6.0, 0.2, 0.05)
R_MAIN = (1.0, 0.01)
QN_SCALE_MAIN = 100.0
# session4_sol.py:166-169
Q_SOL = (1.0, 3.0, 0.1, 0.01)
QN_SCALE_SOL = 10.0
# template.py:136 (the RK4-prediction template variant)
QN_SCALE_TEMPLATE = 5.0
