"""annonet_train on the port: train semantic-segmentation networks on anno
data, on one CUDA device.

The flags are the JAX package's (``annonet_tpu/cli/train.py``
build_parser: the same names, short aliases, types, defaults and
choices), and so are the printed echo lines, the flow and the exit codes:
1 with no arguments and for setup errors (dataset scan, class parsing, no
CUDA device), 2 for a bad parse or downscaling factor and for an error in
the training loop (its tail included: the last loss readback, the final
save and the sync file). Outputs are the reference's: the self-describing
``annonet.dnn`` (BN-folded net, class JSON, downscaling factor) saved
every --save-interval steps and at exit, and the synchronization file
written every 10 minutes (ANNONET_TPU_SYNC_INTERVAL_SECONDS) and resumed
at start — both the JAX package's files, so either package resumes or
loads what the other wrote.

The loop runs on ``--device`` (default 0; ANNONET_TPU_TORCH_DEVICE=cpu
runs it on the CPU): crop decisions from the loader threads, the crops
gathered on the device from the device image pool (--device-image-cache,
auto = on unless --further-downscaling-factor > 1), augmentation, loss
weights, forward, backward and SGD on the device, losses read back every
--loss-sync-interval steps. --validation-directory scores each saved net
through the port's TiledInferer (the inference kernels; int8 with
--validation-quantize int8), which keeps one inferer across saves
(``update_params``). --profile DIR writes a torch.profiler trace of the
loop; ANNONET_TPU_STEP_TIMING=1 prints each step's host time.

--steps-per-dispatch is accepted and its K steps are dispatched one by
one (the JAX package documents its scan superstep as K single
dispatches); --no-compilation-cache is accepted and does nothing. Flags
whose feature is not ported yet exit with code 2 and name the roadmap
item: --mesh, --coordinator, --num-processes, --process-id (data-parallel
training) and --int8-training.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

from annonet_tpu_torch.cli.common import ReferenceParser

#: the --profile trace file's name inside the trace directory
TRAIN_TRACE_FILE = "annonet_train.pt.trace.json"


def build_parser() -> argparse.ArgumentParser:
    p = ReferenceParser(
        prog="annonet_train",
        description="Train semantic-segmentation networks using data generated in anno",
    )
    p.add_argument("input_directory_positional", nargs="?", metavar="input-directory")
    p.add_argument("-i", "--input-directory", dest="input_directory")
    p.add_argument("-d", "--initial-downscaling-factor", type=float, default=1.0,
                   help="The initial downscaling factor (>= 1.0)")
    p.add_argument("-f", "--further-downscaling-factor", type=float, default=1.0,
                   help="The further downscaling factor (>= 1.0)")
    p.add_argument("-u", "--allow-flip-upside-down", action="store_true",
                   help="Randomly flip input images upside down")
    p.add_argument("-l", "--allow-flip-left-right", action="store_true",
                   help="Randomly flip input images horizontally")
    p.add_argument("--multiplicative-brightness-change-probability",
                   type=float, default=0.0)
    p.add_argument("--multiplicative-brightness-change-sigma",
                   type=float, default=0.1)
    p.add_argument("-n", "--noise-level-stddev", type=float, default=0.0,
                   help="Set the standard deviation of the noise to add")
    p.add_argument("-o", "--allow-random-color-offset", action="store_true",
                   help="Randomly apply color offsets")
    p.add_argument("--ignore-class", type=int, action="append", default=[],
                   help="Ignore specific classes by index")
    p.add_argument("--ignore-large-nonzero-regions-by-area", type=float,
                   default=math.inf)
    p.add_argument("--ignore-large-nonzero-regions-by-width", type=float,
                   default=math.inf)
    p.add_argument("--ignore-large-nonzero-regions-by-height", type=float,
                   default=math.inf)
    p.add_argument("--class-weight", type=float, default=0.5,
                   help="Try 0.0 for equally balanced pixels, and 1.0 for equally balanced classes")
    p.add_argument("--image-weight", type=float, default=0.5,
                   help="Try 0.0 for equally balanced pixels, and 1.0 for equally balanced images")
    p.add_argument("-b", "--minibatch-size", type=int, default=100)
    p.add_argument("--input-dimension-multiplier", type=float, default=3.0,
                   help="Size of input patches, relative to minimum required")
    p.add_argument("--net-width-scaler", type=float, default=1.0)
    p.add_argument("--net-width-min-filter-count", type=int, default=1)
    p.add_argument("--initial-learning-rate", type=float, default=0.1)
    p.add_argument("--learning-rate-shrink-factor", type=float, default=0.1)
    p.add_argument("--min-learning-rate", type=float, default=1e-6)
    p.add_argument("--save-interval", type=int, default=1000,
                   help="Save the resulting inference network every this many steps")
    p.add_argument("-t", "--relative-training-length", type=float, default=2.0)
    p.add_argument("--max-total-steps", type=int, default=None)
    p.add_argument("-c", "--cached-image-count", type=int, default=8)
    p.add_argument("--data-loader-thread-count", type=int,
                   default=os.cpu_count() or 1)
    p.add_argument("--deterministic-data", action="store_true",
                   help="Draw the crop-decision stream from a single "
                        "deterministic generator, independent of "
                        "--data-loader-thread-count (the other loader "
                        "threads become decode prefetchers, so decode "
                        "still runs in parallel). Forced on by "
                        "--coordinator: every process must compute the "
                        "identical stream")
    p.add_argument("--no-empty-label-image-warning", action="store_true")
    p.add_argument("--device", "--primary-cuda-device", dest="device",
                   type=int, default=None, help="CUDA device index")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="Train data-parallel over N devices (not ported "
                        "yet)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="Multi-host training (not ported yet)")
    p.add_argument("--num-processes", type=int, default=None, metavar="P",
                   help="Total process (host) count for --coordinator")
    p.add_argument("--process-id", type=int, default=None, metavar="I",
                   help="This process's index (0..P-1) for --coordinator; "
                        "process 0 writes the model/sync/metrics files")
    # runtime versions of the reference's compile-time knobs
    p.add_argument("--level-count", type=int, default=2,
                   help="Downsampling level count (was DLIB_DNN_PIMPL_WRAPPER_LEVEL_COUNT)")
    p.add_argument("--grayscale", action="store_true",
                   help="Grayscale input (was DLIB_DNN_PIMPL_WRAPPER_GRAYSCALE_INPUT)")
    p.add_argument("--output", default="annonet.dnn",
                   help="Model artifact path (reference name: annonet.dnn)")
    p.add_argument("--sync-file", default="annonet_trainer_state_file.dat")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Capture a torch.profiler trace of the training loop "
                        "(a Chrome trace file in DIR)")
    p.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                   help="Append structured training metrics as JSON lines "
                        "(printed output is unchanged): "
                        "per-step loss/LR events (downsampled to every "
                        "--metrics-interval'th recorded step), LR shrinks, "
                        "model saves, and start/done/error records")
    p.add_argument("--metrics-interval", type=int, default=100, metavar="N",
                   help="Keep every Nth recorded loss event in "
                        "--metrics-jsonl (default 100, the verbose print "
                        "cadence; 1 = every step)")
    p.add_argument("--validation-directory", default=None, metavar="DIR",
                   help="Evaluate the exported net on a held-out anno "
                        "directory after every model save: per-pixel accuracy and per-class "
                        "recall are printed and, with --metrics-jsonl, "
                        "recorded as validation events. Automates the "
                        "reference's manual train-then-annonet_infer "
                        "check; validation shares the device, so training "
                        "pauses while it runs (tune --save-interval)")
    p.add_argument("--validation-quantize", choices=["none", "int8"],
                   default="none",
                   help="Run validation through the int8 quantized path "
                        "instead of the exact float path — validate what "
                        "an `annonet_infer --quantize int8` deployment "
                        "will serve (activation scales recalibrate on "
                        "the first validation image after each save)")
    p.add_argument("--remat", action="store_true",
                   help="Rematerialize activations in the backward pass "
                        "(fits larger minibatches; ~1/3 more compute)")
    p.add_argument("--int8-training", action="store_true",
                   help="Quantization-aware training (not ported yet)")
    p.add_argument("--no-compilation-cache", action="store_true",
                   help="Accepted for flag parity; the port keeps no "
                        "compilation cache")
    p.add_argument("--device-image-cache", choices=["auto", "on", "off"],
                   default="auto",
                   help="Keep the decoded-image cache in device HBM and "
                        "extract crops on device, so each step uploads "
                        "~20 bytes/crop of indices instead of the crop "
                        "pixels (the host LRU still owns "
                        "decode lifetimes). auto = on when "
                        "--further-downscaling-factor <= 1; off = always "
                        "upload pixels (reference-like)")
    p.add_argument("--loss-sync-interval", type=int, default=8,
                   help="Read device losses back every N steps (default 8). "
                        "dlib's dnn_trainer behind the reference's "
                        "StartTraining (annonet_train_main.cpp:609) runs "
                        "steps on its own thread and surfaces losses with a "
                        "lag, so batched readback matches its semantics; the "
                        "plateau detector sees losses up to 2N-1 steps late "
                        "(the flush lags a full interval so it never stalls "
                        "the in-flight pipeline). "
                        "1 = block per step (fully synchronous)")
    p.add_argument("--steps-per-dispatch", type=int, default=8,
                   help="Accepted for flag parity: the JAX package scans K "
                        "steps into one device dispatch, numerically K "
                        "single dispatches; the port dispatches the K "
                        "steps one by one")
    return p


_UNSET = object()
# (flag, dest, roadmap item): refused whenever the flag is on the command line
_UNPORTED = (
    ("--mesh", "mesh", 6),
    ("--coordinator", "coordinator", 6),
    ("--num-processes", "num_processes", 6),
    ("--process-id", "process_id", 6),
    ("--int8-training", "int8_training", 7),
)


def _unported(args):
    """The message for the first unported flag the user passed, or None."""
    for flag, dest, item in _UNPORTED:
        if getattr(args, dest) is not _UNSET:
            return (f"annonet_train: {flag} is not ported to annonet_tpu_torch yet "
                    f"(ROADMAP.md queue 1 item {item})")
    return None


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if not argv:
        # argc == 1: usage to stdout, exit 1 (annonet_train_main.cpp:262-269)
        print("To run this program you need data annotated using the anno program.")
        print()
        print("You call this program like this: ")
        print("./annonet_train /path/to/anno/data")
        return 1

    parser = build_parser()
    # a sentinel default tells "flag given" from "default" for the
    # unported flags; build_parser itself stays the JAX package's table
    parser.set_defaults(**{dest: _UNSET for _flag, dest, _item in _UNPORTED})
    try:
        args = parser.parse_args(argv)
        input_directory = args.input_directory or args.input_directory_positional
        if not input_directory:
            parser.error("Option 'input-directory' is required but not present")
        # the reference echoes these three lines inside the parse try-block
        # (annonet_train_main.cpp:322-328), before validating the factors
        print(f"Input directory = {input_directory}")
        print(f"Initial downscaling factor = {args.initial_downscaling_factor:g}")
        print(f"Further downscaling factor = {args.further_downscaling_factor:g}")
        if args.initial_downscaling_factor <= 0.0 or args.further_downscaling_factor <= 0.0:
            parser.error("The downscaling factors have to be strictly positive.")
    except SystemExit as e:
        return int(e.code or 0)
    message = _unported(args)
    if message:
        print(message, file=sys.stderr)
        return 2
    # setup errors print the message and exit 1 (annonet_train_main.cpp:
    # 640-644); errors inside the training loop exit 2 (in _run)
    try:
        return _run(args, input_directory)
    except Exception as e:  # noqa: BLE001
        print(e)
        return 1


def _sync_interval_seconds() -> float:
    """The sync-file period: the reference's 10 minutes
    (annonet_train_main.cpp:403), or ANNONET_TPU_SYNC_INTERVAL_SECONDS
    (> 0)."""
    raw = os.environ.get("ANNONET_TPU_SYNC_INTERVAL_SECONDS")
    if raw is None:
        return 600.0
    try:
        value = float(raw)
    except ValueError:
        value = -1.0
    if not value > 0.0:
        raise RuntimeError(
            f"ANNONET_TPU_SYNC_INTERVAL_SECONDS={raw!r} must be a "
            "positive number of seconds"
        )
    return value


def _run(args, input_directory) -> int:
    import contextlib

    with contextlib.ExitStack() as stack:
        return _run_impl(args, input_directory, stack)


def _run_impl(args, input_directory, stack) -> int:
    # echo configuration, parity with annonet_train_main.cpp:336-374
    print("Allow flipping input images upside down =",
          "yes" if args.allow_flip_upside_down else "no")
    print(f"Minibatch size = {args.minibatch_size}")
    print(f"Net width scaler = {args.net_width_scaler:g}, "
          f"min filter count = {args.net_width_min_filter_count}")
    print(f"Initial learning rate = {args.initial_learning_rate:g}")
    print(f"Learning rate shrink factor = {args.learning_rate_shrink_factor:g}")
    print(f"Min learning rate = {args.min_learning_rate:g}")
    print(f"Save interval = {args.save_interval}")
    print(f"Relative training length = {args.relative_training_length:g}")
    print(f"Cached image count = {args.cached_image_count}")
    print(f"Data loader thread count = {args.data_loader_thread_count}")
    if args.deterministic_data:
        print("Deterministic data stream = true")
    if args.ignore_class:
        print("Classes to ignore =", " ".join(str(c) for c in args.ignore_class))

    from annonet_tpu_torch import serialization
    from annonet_tpu_torch.classes import parse_anno_classes
    from annonet_tpu_torch.cli.common import resolve_device
    from annonet_tpu_torch.data.crop import CropOptions
    from annonet_tpu_torch.data.dataset import find_image_files, read_anno_classes_file
    from annonet_tpu_torch.data.pipeline import CropPipeline, RegionFilterOptions
    from annonet_tpu_torch.models.segnet import (
        SegNetConfig,
        recommended_input_dimension,
        required_input_dimension,
    )
    from annonet_tpu_torch.train.trainer import Trainer, TrainerConfig

    relative_training_length = max(0.01, args.relative_training_length)

    if args.grayscale and args.allow_random_color_offset:
        print(
            "Warning: --allow-random-color-offset has no effect with "
            "--grayscale (color offsets need RGB input)"
        )

    def model_config_for(class_count):
        return SegNetConfig(
            class_count=class_count,
            level_count=args.level_count,
            width_scaler=args.net_width_scaler,
            min_filter_count=args.net_width_min_filter_count,
            grayscale=args.grayscale,
        )

    model_config = model_config_for(2)  # the class count does not size the crop
    required_dim = required_input_dimension(model_config)
    print(f"Required input dimension = {required_dim}")
    requested_dim = int(round(args.input_dimension_multiplier * required_dim))
    print(f"Requested input dimension = {requested_dim}")
    actual_dim = recommended_input_dimension(model_config, requested_dim)
    print(f"Actual input dimension = {actual_dim}")

    anno_classes_json = read_anno_classes_file(input_directory)
    anno_classes = parse_anno_classes(anno_classes_json)
    model_config = model_config_for(len(anno_classes))
    device = resolve_device(args.device)

    trainer_config = TrainerConfig(
        initial_learning_rate=args.initial_learning_rate,
        learning_rate_shrink_factor=args.learning_rate_shrink_factor,
        min_learning_rate=args.min_learning_rate,
        iterations_without_progress_threshold=int(round(relative_training_length * 2000)),
        previous_loss_values_dump_amount=int(round(relative_training_length * 400)),
        bn_stats_window=int(round(relative_training_length * 100)),
        remat=args.remat,
        loss_sync_interval=max(1, args.loss_sync_interval),
        sync_file=args.sync_file,
        sync_interval_seconds=_sync_interval_seconds(),
        verbose=True,
    )
    minibatch_size = args.minibatch_size
    trainer = Trainer(model_config, trainer_config, seed=args.seed, device=device)

    metrics = None
    if args.metrics_jsonl:
        from annonet_tpu_torch.utils.metrics import MetricsWriter

        metrics = MetricsWriter(args.metrics_jsonl, args.metrics_interval)
        stack.callback(metrics.close)
        trainer.metrics_hook = metrics.hook
        metrics.event(
            "start",
            input_directory=input_directory,
            minibatch_size=minibatch_size,
            class_count=len(anno_classes),
            level_count=args.level_count,
            grayscale=args.grayscale,
            net_width_scaler=args.net_width_scaler,
            initial_learning_rate=args.initial_learning_rate,
            min_learning_rate=args.min_learning_rate,
            initial_downscaling_factor=args.initial_downscaling_factor,
            further_downscaling_factor=args.further_downscaling_factor,
            mesh=None,
            seed=args.seed,
            resumed_at_step=trainer.step_count,
        )

    print("\nSCANNING ANNO DATASET\n")
    image_files = find_image_files(input_directory, require_ground_truth=True)
    print(f"images in dataset: {len(image_files)}")
    if not image_files:
        print("Didn't find an anno dataset. ")
        return 1

    crop_options = CropOptions(
        dim=actual_dim,
        further_downscaling_factor=args.further_downscaling_factor,
        class_weight=args.class_weight,
        image_weight=args.image_weight,
        allow_flip_left_right=args.allow_flip_left_right,
        allow_flip_upside_down=args.allow_flip_upside_down,
        multiplicative_brightness_change_probability=(
            args.multiplicative_brightness_change_probability
        ),
        multiplicative_brightness_change_sigma=args.multiplicative_brightness_change_sigma,
        noise_level_stddev=args.noise_level_stddev,
        allow_random_color_offset=args.allow_random_color_offset,
    )
    region_filter = RegionFilterOptions(
        receptive_field_side=required_dim,
        by_area=args.ignore_large_nonzero_regions_by_area,
        by_width=args.ignore_large_nonzero_regions_by_width,
        by_height=args.ignore_large_nonzero_regions_by_height,
    )
    downscaling_total = args.initial_downscaling_factor * args.further_downscaling_factor

    # --validation-directory: read and check the whole set up front, so
    # data problems are setup errors (exit 1), not a failed save hours in
    validation_samples: list = []
    validation_state: list = []
    if args.validation_quantize != "none" and not args.validation_directory:
        raise RuntimeError("--validation-quantize requires --validation-directory")
    if args.validation_directory:
        from annonet_tpu_torch.data.sample import read_sample

        validation_files = find_image_files(args.validation_directory,
                                            require_ground_truth=True)
        if not validation_files:
            raise RuntimeError(
                "Didn't find an anno dataset in --validation-directory "
                f"{args.validation_directory}"
            )
        for f in validation_files:
            s = read_sample(f, anno_classes, True, downscaling_total, args.grayscale)
            if s.error:
                print(f"validation: skipping {f.image_filename}: {s.error}")
                continue
            validation_samples.append(s)
        if not validation_samples:
            raise RuntimeError(
                f"No readable validation samples in {args.validation_directory}"
            )

    def run_validation(runtime_net):
        from annonet_tpu_torch.infer.core import TiledInferer, annonet_infer
        from annonet_tpu_torch.infer.evaluation import (
            confusion_matrix_summary,
            new_confusion_matrix,
            update_confusion_matrix_per_pixel,
        )

        # one inferer across validations: update_params swaps the weights
        if validation_state:
            inferer = validation_state[0]
            inferer.update_params(runtime_net)
        else:
            inferer = TiledInferer(
                runtime_net, model_config, device=device,
                quantize=None if args.validation_quantize == "none" else args.validation_quantize,
            )
            validation_state.append(inferer)
        cm = new_confusion_matrix(len(anno_classes))
        px = 0
        for s in validation_samples:
            labels = annonet_infer(inferer, s.input_image)
            px += update_confusion_matrix_per_pixel(cm, s.labeled_points_by_class, labels)
        summary = confusion_matrix_summary(cm, anno_classes)
        recalls = " ".join(
            f"{c['index']}:{c['recall'] * 100.0:.2f}%"
            for c in summary["classes"]
            if c["recall"] is not None
        )
        accuracy = summary["accuracy"]
        accuracy_text = (
            f"{accuracy * 100.0:.2f} %" if accuracy is not None
            else "n/a (no labeled pixels)"
        )
        print(
            f"validation (step {trainer.step_count}): accuracy = "
            f"{accuracy_text} over {px} labeled px, "
            f"{len(validation_samples)} images; recall {recalls}"
        )
        if metrics is not None:
            metrics.event(
                "validation",
                step=trainer.step_count,
                accuracy=accuracy,
                labeled_pixels=px,
                images=len(validation_samples),
                classes=summary["classes"],
            )

    def save_inference_net():
        print("saving network")
        runtime_net = trainer.runtime_net()
        serialization.save_model(args.output, runtime_net, model_config, anno_classes_json,
                                 downscaling_factor=downscaling_total)
        if metrics is not None:
            metrics.event("save", step=trainer.step_count, path=args.output)
        if validation_samples:
            run_validation(runtime_net)

    print("\nNow training...")
    from annonet_tpu_torch.utils import profiler_trace, set_low_priority

    set_low_priority()  # annonet_train_main.cpp:514
    warnings_already_printed = set()
    minibatch = 0
    train_started = time.monotonic()

    # the device image pool: crops gathered on the device from a pool that
    # mirrors the host LRU; only the further-downscaling path uploads
    # pixels (and a pixel batch from the pin-budget fallback still trains
    # through train_step_crops)
    device_pool = None
    if args.device_image_cache != "off" and args.further_downscaling_factor <= 1.0:
        from annonet_tpu_torch.train.device_cache import DeviceImagePool

        device_pool = DeviceImagePool(slots=max(1, args.cached_image_count), device=device)
    elif args.device_image_cache == "on":
        raise RuntimeError(
            "--device-image-cache on requires --further-downscaling-factor <= 1"
        )

    with CropPipeline(
        image_files,
        anno_classes,
        crop_options,
        initial_downscaling_factor=args.initial_downscaling_factor,
        grayscale=args.grayscale,
        classes_to_ignore=args.ignore_class,
        region_filter=region_filter,
        cached_image_count=args.cached_image_count,
        thread_count=max(1, args.data_loader_thread_count),
        queue_depth=2 * args.minibatch_size,
        seed=args.seed,
        deterministic=args.deterministic_data,
    ) as pipe:
        # errors inside the training loop print the message and exit 2
        # (annonet_train_main.cpp:616-620; the final save is skipped)
        step_timing = os.environ.get("ANNONET_TPU_STEP_TIMING") == "1"
        try:
            with profiler_trace(args.profile, device, TRAIN_TRACE_FILE):
                while True:
                    t0 = time.monotonic()
                    if trainer.should_stop:
                        break
                    if args.max_total_steps is not None and minibatch >= args.max_total_steps:
                        break
                    warn = None if args.no_empty_label_image_warning else print
                    if device_pool is not None:
                        kind, a, b = pipe.next_decisions(
                            minibatch_size, warn=warn,
                            warnings_already_printed=warnings_already_printed,
                        )
                        if kind == "decisions":
                            trainer.train_step_decisions(device_pool, a, b, crop_options,
                                                         seed=args.seed)
                        else:
                            trainer.train_step_crops(a, b, crop_options, seed=args.seed)
                    else:
                        images, labels = pipe.next_minibatch(
                            minibatch_size, warn=warn,
                            warnings_already_printed=warnings_already_printed,
                        )
                        trainer.train_step_crops(images, labels, crop_options, seed=args.seed)
                    if step_timing:
                        extra = "" if device_pool is None else f" uploads={device_pool.uploads}"
                        print(f"[step {minibatch}] {time.monotonic() - t0:.3f}s{extra}",
                              flush=True)
                    if minibatch % args.save_interval == 0:
                        save_inference_net()
                    minibatch += 1
        except Exception as e:  # noqa: BLE001
            print(e)
            if metrics is not None:
                metrics.event("error", message=str(e))
            return 2

    # the tail is still loop work: a divergence in the last pending losses
    # keeps the exit-2 contract, and vetoes the save of poisoned weights
    try:
        trainer.flush_losses()
        save_inference_net()
        trainer.save_sync_file()
    except Exception as e:  # noqa: BLE001
        print(e)
        if metrics is not None:
            metrics.event("error", message=str(e))
        return 2
    if metrics is not None:
        metrics.event(
            "done",
            steps=trainer.step_count,
            steps_this_run=minibatch,
            wall_seconds=round(time.monotonic() - train_started, 3),
        )
    return 0



if __name__ == "__main__":
    sys.exit(main())
