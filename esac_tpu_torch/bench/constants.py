"""The bench's shapes, counts and windows (a copy of ``bench.py``'s, never an
import of it): every mode measures what the JAX bench measures, at the same
frames, hypotheses, cells, image sizes, experts, buckets, load multiples and
windows.

Left out, with no counterpart: the relay probe's and the device child's
deadlines (``PROBE_DEADLINE_S``, ``DEVICE_DEADLINE_S``: the port runs in
process on the card), the root dotfile paths (the port writes
``scaffold.ARTIFACT_DIR``) and ``HOSTPATH_BASELINE_RPS`` (a CPU number of the
JAX package; the port's capacity gate keys hold ``None``).
"""

N_HYPS = 256
CELLS = 4800        # 80x60 coordinate grid (BASELINE.md config #1)
BATCH = 16          # frames per dispatch of the headline pipeline
REPEATS = 20
SERVE_BUCKETS = (1, 4, 16, 64)  # frame-batch sweep (DESIGN.md §9)
SERVE_FRAMES = 64   # total frames per sweep leg -> fixed total hypotheses
SERVE_HYPS = 16     # per-request hypotheses: the serving operating point
SERVE_REPEATS = 5   # median-of-5 per leg (spread recorded)
STREAM_MESH_CHIPS = 8   # config #5's mesh size; one card measures
STREAM_BATCH = 64       # one chip's shard (STREAM_BATCH // STREAM_MESH_CHIPS)
C = (320.0, 240.0)

REGISTRY_SCENES = 3      # synthetic fleet size for the registry sweep
REGISTRY_REPEATS = 7     # per-latency-class sample count (median + spread)

LOADTEST_M = 4           # experts in the SLO loadtest's synthetic scenes
LOADTEST_HW = 24         # tiny frames: the loadtest measures QUEUEING
LOADTEST_HYPS = 4        # per-expert hypotheses per request
LOADTEST_BUCKETS = (2, 8)   # the two frame buckets of the sweep matrix
LOADTEST_MULTS = (0.4, 0.8, 1.2, 2.0)  # offered load in multiples of the
                                       # measured closed-loop capacity
LOADTEST_SECONDS = 2.5   # open-loop window per load point

SCORING_SWEEP = (64, 256, 1024)  # n_hyps sweep of the scoring-impl legs
SCORING_BATCH = 16       # frames per dispatch: the serve operating point
SCORING_REPEATS = 5      # median-of-5 per (impl, n_hyps) leg

ROUTED_M = 8             # experts in the routed-serve sweep
ROUTED_FRAMES = 16       # frames per dispatch (one frame bucket)
ROUTED_HYPS = 8          # per-expert hyps at dense; total M*this is FIXED
ROUTED_HW = 96           # image size: the expert CNNs dominate the dispatch
ROUTED_REPEATS = 5       # median-of-5 per leg

OBS_FRAMES = 24          # requests per timed pass of the obs overhead gate
OBS_HYPS = 16            # per-request hypotheses: the serve operating point
OBS_REPEATS = 9          # interleaved off/on passes

PREFETCH_SCENES = 12     # fleet size of the tier sweep: 4x the device budget
PREFETCH_OVERSUB_X = 4   # device oversubscription: budget = n_scenes/this
PREFETCH_REQUESTS = 240  # Zipf trace length per leg (same trace, 3 legs)
PREFETCH_ZIPF_A = 1.1    # scene-popularity skew
PREFETCH_HW = 24         # tiny frames: the sweep measures WEIGHT LOCALITY
PREFETCH_M = 2
PREFETCH_HYPS = 4

FLEET_REPLICAS = 3       # serving replicas in the fleet bench
FLEET_SCENES = 6         # scenes sharded over the replicas by affinity
FLEET_M = 2              # experts per scene (tiny: the bench measures
FLEET_HW = 24            # SCHEDULING -- affinity, failover, accounting)
FLEET_HYPS = 4
FLEET_BUCKET = 2         # one frame bucket per replica dispatcher
FLEET_ZIPF_A = 1.1       # scene-popularity skew of the arrival trace
FLEET_MULTS = (0.4, 0.7, 1.0)  # offered load in multiples of the
                               # AGGREGATE (n-replica) capacity
FLEET_SECONDS = 1.5      # open-loop window per point
FLEET_DRILL_RATE_X = 0.5  # drill load vs aggregate capacity (below the knee)

CHAOS_M = 2              # experts in the chaos drill's synthetic scenes
CHAOS_HW = 24            # tiny frames: the drill measures FAULT routing
CHAOS_HYPS = 4           # per-expert hypotheses per request
CHAOS_BUCKET = 2         # one frame bucket: fault accounting, not sweep
CHAOS_RATE_X = 0.5       # offered load vs closed-loop capacity (below knee)
CHAOS_SECONDS = 2.0      # open-loop window per phase

CITY_SCENES = 24         # procedural "districts" in the retrieval drill
CITY_REPLICAS = 2        # serving replicas
CITY_HW = 16             # tiny frames: RETRIEVAL routing quality and
CITY_M = 2               # exact accounting, not throughput
CITY_HYPS = 4
CITY_BUCKET = 1          # image requests arrive alone (no batch axis)
CITY_TOPKS = (1, 2, 4)   # retrieval fan-out sweep: recall@K vs latency
CITY_EMBED = 16          # retriever embedding dim
CITY_MAX_SCENES = 32     # static prototype axis (headroom over CITY_SCENES)
CITY_TRAIN_STEPS = 200   # symmetric-InfoNCE retriever fit (bench prep)
CITY_OVERSUB_X = 4.0     # weight-cache budget = total scene bytes / this
CITY_EASY = 16           # per-leg query mix: near-reference views ...
CITY_HARD = 8            # ... heavy-noise ambiguous views ...
CITY_JUNK = 6            # ... and out-of-fleet junk images

SESSIONS_HW = 24         # tiny frames in the registry legs
SESSIONS_M = 2           # experts per scene in the registry legs
SESSIONS_FULL_HYPS = 64  # the scene's configured full budget
SESSIONS_TRACK_HYPS = 8  # shrunken tracked budget (prewarmed override)
SESSIONS_PRIOR_SLOTS = 4  # static prior-slot count P of the session lane
SESSIONS_SEQ_FRAMES = 48  # continuous-trajectory sequence length
SESSIONS_SEQ_FULL = 256  # coords-level full budget of the sequence legs
SESSIONS_SEQ_TRACK = 32  # coords-level tracked budget
SESSIONS_LOAD_SESSIONS = (2, 4, 8)  # concurrent sessions: the loadtest's
                                    # unit of offered load
SESSIONS_LOAD_FRAMES = 16           # frames streamed per session

HOSTPATH_REQUESTS = 300  # traced closed-loop requests for the stage table
