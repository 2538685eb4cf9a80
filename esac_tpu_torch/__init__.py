"""PyTorch/CUDA port of ``esac_tpu``: multi-expert ESAC relocalization on
an NVIDIA H100.

The package mirrors ``esac_tpu``'s layout so each module's counterpart is
where a reader looks for it, and keeps the JAX package's public layouts
(images NHWC, coordinates ``(..., N, 3)``, poses axis-angle ``(..., 3)``)
so the tests run the same numpy inputs through both.  It imports ``torch``
and numpy only -- never ``jax``, ``flax`` or anything under ``esac_tpu``.

Entry points (``ransac.kernel.dsac_infer[_frames]``,
``ransac.esac.esac_infer[_frames]``, the top-k, routed and prior-slot
entries ``esac_infer_topk[_frames]``, ``esac_infer_routed_frames[_prior]``,
``esac_infer_prior``, ``esac_infer_frames_prior``, and
``registry.serving.make_scene_bucket_fn`` /
``make_routed_scene_bucket_fn``) run on the card unless the caller passes
``device="cpu"``; they raise when CUDA is missing instead of falling back.
``parallel.esac_sharded.route_frames_to_experts`` is the routed path's
capacity dispatch.  The two soft-inlier scoring
kernels are hand-written CUDA (``csrc/soft_inlier.cu``), built with
``nvcc`` at first use (``_build.py``).

Training: the losses (``ransac.kernel.dsac_train_loss[_frames]``,
``ransac.esac.esac_train_loss[_frames]``) are differentiable by autograd,
the kernels through their ``torch.autograd.Function``s
(``ransac.fused_scoring``), and ``train`` holds the three stages' step
factories (``make_expert_train_step``, ``make_gating_train_step``,
``make_dsac_train_step``, ``make_esac_train_step``).

Serving front end: ``registry.serving.SceneRegistry`` (a versioned
``registry.manifest.SceneManifest``, scenes in CUDA memory under a byte
budget in ``registry.cache.DeviceWeightCache``, checksums, hot swap,
canary and the ``registry.health`` breaker) and its ``dispatcher(cfg)``, a
``serve.dispatcher.MicroBatchDispatcher`` that coalesces single-frame
requests into frame buckets under ``serve.slo`` deadlines and admission
control; ``serve.loadgen`` replays open-loop traffic and ``obs`` holds
the counters, histograms and traces they publish.

Workflow: ``data`` (synthetic and on-disk scenes, augmentation),
``utils.checkpoint`` (torch checkpoints, crash-atomic train states),
``utils.profiling``, ``cli`` and ``scripts`` (``train_expert``,
``train_gating``, ``train_esac``, ``test_esac``, ``convert_checkpoint``;
each ``main(argv)``, run as ``python -m esac_tpu_torch.scripts.<name>``).
"""
