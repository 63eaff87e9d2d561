"""annonet_infer on the port: tiled inference over a directory of images.

The flags are the JAX package's (``annonet_tpu/cli/infer.py``
build_parser: the same names, short aliases, types, defaults and
choices), and so are the flow and the printed output: deserialize the
self-describing model, then for each image in ``find_image_files`` order
read it, infer, veto seedless blobs, write ``<image>_result.png`` at the
original size, and accumulate the per-pixel and per-region confusion
matrices when ground truth exists; finally print the timing report and
the matrices.

The loop is the JAX CLI's pipeline on one CUDA device (``--device``,
default 0; ANNONET_TPU_TORCH_DEVICE=cpu runs it on the CPU):
``--full-image-reader-thread-count`` reader threads decode images ahead,
within a read-ahead window, into a buffer consumed in file order;
``--result-image-writer-thread-count`` writer threads resize, colour and
encode the result PNGs; up to ``--pipeline-depth`` groups of
``--image-batch`` same-size images are in flight on the device: a group's
forward is queued with the copy of its labels and seeds to the host, and
the next group is queued before that copy is waited for, so the host's
blob veto and confusion matrices of one group overlap the device's work
on the next. Depth 1 with one reader and one writer is the reference's
sequential loop; the results are the same at any depth and thread count.
The inferer stays on the main thread; the threads touch numpy and PIL
only. ``--profile DIR`` writes a torch.profiler trace of the loop.
``--no-compilation-cache`` has nothing to disable (the kernels are built
once per source hash). ``--quantize int8`` runs the int8 net, with
``--calibration-images``, ``--calibration`` / ``--save-calibration``
(files either package reads) and ``--blend-dtype``; after the loop it
prints the calibration overshoot of the last image, as the JAX CLI does.
``--plan-autotune`` times the default tile plan and its denser
neighbours on the first image of each canvas size and runs the fastest,
and prints the JAX CLI's report line. The device is probed first
(``cli/common.py::device_probe``).

``--mesh N`` is tile-parallel inference: each image's tile batch is split
over the first N CUDA devices (``TiledInferer(mesh=...)``), or, under
ANNONET_TPU_VIRTUAL_MESH=1, over N virtual shards of the one device.
``--coordinator HOST:PORT --num-processes P --process-id I`` is
multi-process batch inference, as in the JAX CLI: every process scans the
same directory and infers the images ``I, I+P, ...``, on
``cuda:(I mod device count)`` unless ``--device`` names one (so several
processes may share a card); one all-gather at the end merges the
confusion matrices and timings (it is also the exit barrier), and process
0 alone prints the cluster totals and matrices and writes
``--report-json`` and the max-merged ``--save-calibration``. The group is
gloo's over TCP (parallel/mesh.py); a collective that fails because a
peer died exits with code 3 (``cli/common.py::exit_on_peer_failure``).
"""

from __future__ import annotations

import argparse
import collections
import os
import queue
import sys
import threading
import time

from annonet_tpu_torch.cli.common import ReferenceParser


def build_parser() -> argparse.ArgumentParser:
    p = ReferenceParser(
        prog="annonet_infer",
        description="Do inference using trained semantic-segmentation networks",
        add_help=False,
    )
    p.add_argument("--help", action="help")
    p.add_argument("input_directory_positional", nargs="?", metavar="input-directory")
    p.add_argument("-i", "--input-directory", dest="input_directory")
    p.add_argument("-g", "--gain", action="append", default=[],
                   help="Supply a class-specific gain, for example: 1:-0.5")
    p.add_argument("-d", "--detection", action="append", default=[],
                   help="Supply a class-specific detection level that _comes on top of gain_, for example: 1:1.5")
    p.add_argument("-w", "--tile-max-width", type=int, default=None,
                   help="Max tile width (default: 1024, the reference's "
                        "CUDA default)")
    p.add_argument("-h", "--tile-max-height", type=int, default=None,
                   help="Max tile height (default: 1024, like -w)")
    p.add_argument("--full-image-reader-thread-count", type=int,
                   default=os.cpu_count() or 1)
    p.add_argument("--result-image-writer-thread-count", type=int,
                   default=os.cpu_count() or 1)
    p.add_argument("--model", default="annonet.dnn",
                   help="Model artifact path (reference name: annonet.dnn)")
    p.add_argument("--device", "--primary-cuda-device", dest="device",
                   type=int, default=None, help="CUDA device index")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Capture a torch.profiler trace of the inference "
                        "loop (a Chrome trace file in DIR)")
    p.add_argument("--report-json", default=None, metavar="PATH",
                   help="Write a machine-readable run report: per-image "
                        "timings, the timing summary, and — when ground "
                        "truth exists — both confusion matrices with "
                        "per-class recall/precision and total accuracy")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="Images in flight on the device: the next image is "
                        "dispatched before the current result is read back "
                        "(1 = fully sequential like the reference). At "
                        "depth > 1 the per-image timing stats report "
                        "device-busy time (overlap with host work is not "
                        "double-counted)")
    p.add_argument("--image-batch", type=int, default=1, metavar="N",
                   help="Forward up to N consecutive SAME-SIZE images as "
                        "one tile batch; per-image timings become the "
                        "batch average")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="Tile-parallel inference: split each image's tile "
                        "batch over N CUDA devices")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="Multi-host batch inference: process 0's address "
                        "(or 'auto' under torchrun); each process infers "
                        "every P-th image and process 0 reports the merge")
    p.add_argument("--num-processes", type=int, default=None, metavar="P",
                   help="Total process (host) count for --coordinator")
    p.add_argument("--process-id", type=int, default=None, metavar="I",
                   help="This process's index (0..P-1) for --coordinator")
    p.add_argument("--no-compilation-cache", action="store_true",
                   help="Accepted for flag parity; the port keeps no "
                        "compilation cache")
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="Quantized inference: int8 runs the int8 net, "
                        "calibrated on the first --calibration-images "
                        "images (or loaded with --calibration)")
    p.add_argument("--reference-blend-semantics", action="store_true",
                   help="Compat mode: compare per-class gains (-g) and "
                        "detection levels (-d) against the UNNORMALIZED "
                        "ramp-sum blend accumulation inside tile-overlap "
                        "bands, exactly like the reference "
                        "(annonet_infer.cpp:146-161,176-185,205-211), "
                        "instead of normalizing first. Identical output "
                        "when all gains and levels are zero (PARITY.md)")
    p.add_argument("--calibration-images", type=int, default=1, metavar="N",
                   help="int8: images whose activation maxima set the "
                        "scales; they run the float net before the freeze")
    p.add_argument("--plan-autotune", action="store_true",
                   help="Measured tile-plan selection: on the first image "
                        "of each canvas size, time the default tile plan "
                        "and its denser neighbouring grids on the device "
                        "and run the fastest")
    p.add_argument("--blend-dtype", choices=["auto", "float32", "bfloat16"],
                   default="auto",
                   help="Accumulation dtype of the tile-blend epilogue: "
                        "auto = bfloat16 with --quantize int8, else float32")
    p.add_argument("--calibration", default=None, metavar="PATH",
                   help="Load persisted int8 calibration (int8 from the "
                        "first image)")
    p.add_argument("--save-calibration", default=None, metavar="PATH",
                   help="Persist the frozen int8 calibration")
    return p


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if not argv:
        # argc == 1: usage to stdout, exit 1 (annonet_infer_main.cpp:285-293)
        print("You call this program like this: ")
        print("./annonet_infer /path/to/image/data")
        print()
        print("You will also need a trained 'annonet.dnn' file. ")
        print()
        return 1

    parser = build_parser()
    try:
        args = parser.parse_args(argv)
        input_directory = (
            args.input_directory or args.input_directory_positional
        )
        if not input_directory:
            parser.error("Option 'input-directory' is required but not present")
    except SystemExit as e:
        return int(e.code or 0)
    # top-level catch: message and exit 1, like the reference's
    # catch(std::exception&) at the tail of annonet_infer_main.cpp
    try:
        return _run(args, input_directory)
    except Exception as e:  # noqa: BLE001
        from annonet_tpu_torch.cli.common import exit_on_peer_failure

        # a dead PEER surfaces here as a gloo error from the final merge:
        # report it and leave with the peer-failure code
        exit_on_peer_failure(e, bool(args.coordinator))
        print(e)
        if args.coordinator:
            # a rank-local failure leaves the peers blocked in the final
            # merge until this process's exit severs their connections
            print("multi-host: this rank is exiting; peer processes may "
                  "block in the final merge. Restart the job on every host.")
        return 1
    finally:
        if args.coordinator:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


def _run(args, input_directory) -> int:
    print(f"Input directory = {input_directory}")

    import numpy as np

    from annonet_tpu_torch.classes import parse_anno_classes
    from annonet_tpu_torch import serialization
    from annonet_tpu_torch.cli.common import (
        IndexOrderedResults,
        device_probe,
        make_cli_mesh,
        parse_class_specific_values,
        resolve_device,
    )
    from annonet_tpu_torch.data.codec import index_label_image_to_rgba_label_image
    from annonet_tpu_torch.data.dataset import find_image_files
    from annonet_tpu_torch.data.sample import (
        read_sample,
        resize_label_image,
        save_png_rgba,
    )
    from annonet_tpu_torch.infer.core import HostReadback, TiledInferer, detection_veto
    from annonet_tpu_torch.infer.evaluation import (
        format_confusion_matrix,
        new_confusion_matrix,
        update_confusion_matrix_per_pixel,
        update_confusion_matrix_per_region,
    )
    from annonet_tpu_torch.infer.tiling import TilingParameters, default_tile_max
    from annonet_tpu_torch.models.segnet import required_input_dimension
    from annonet_tpu_torch.utils import profiler_trace, set_low_priority

    runtime_params, model_config, anno_classes_json, downscaling_factor = (
        serialization.load_model(args.model)
    )
    print(f"Deserializing annonet, downscaling factor = {downscaling_factor:g}")
    anno_classes = parse_anno_classes(anno_classes_json)
    if len(anno_classes) < 2:
        raise RuntimeError(f"{args.model} declares fewer than 2 anno classes")

    gains = parse_class_specific_values(args.gain, len(anno_classes))
    detection_levels = parse_class_specific_values(
        args.detection, len(anno_classes), require_non_negative=True
    )
    print("Using gains:", " ".join(
        f"{i}:{g:g}" for i, g in enumerate(gains)))
    print("Using detection levels:", " ".join(
        f"{i}:{d:g}" for i, d in enumerate(detection_levels)))

    # Batch inference over a directory is embarrassingly parallel, so the
    # multi-process axis is the image list (process i takes images i,
    # i+P, ...); each process runs its own tiled inference, and only the
    # final merge is a collective (it doubles as the exit barrier).
    multihost = bool(args.coordinator)
    rank, world = 0, 1
    if multihost:
        if args.mesh:
            raise RuntimeError(
                "--coordinator shards images across processes and does "
                "not compose with --mesh (tile-parallel inference is the "
                "in-process axis; for cross-host serving see "
                "docs/SERVING.md)"
            )
        from annonet_tpu_torch.parallel.mesh import initialize_distributed

        rank, world = initialize_distributed(
            args.coordinator, num_processes=args.num_processes,
            process_id=args.process_id,
        )
        print(f"Multi-host inference: process {rank} of {world}")
    io_process = rank == 0

    device = resolve_device(args.device)
    if multihost and args.device is None and device.type == "cuda":
        import torch

        # processes beyond the card count share cards
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device_probe(device)
    mesh = make_cli_mesh(args.mesh, device) if args.mesh else None

    if args.tile_max_width is None:
        args.tile_max_width = default_tile_max()
    if args.tile_max_height is None:
        args.tile_max_height = default_tile_max()
    min_input_dimension = required_input_dimension(model_config)
    if args.tile_max_width < min_input_dimension or args.tile_max_height < min_input_dimension:
        raise RuntimeError(f"Tile size must be at least {min_input_dimension}")
    tiling = TilingParameters(
        max_tile_width=args.tile_max_width,
        max_tile_height=args.tile_max_height,
        overlap_x=min_input_dimension,
        overlap_y=min_input_dimension,
    )
    if args.calibration_images < 1:
        raise RuntimeError("--calibration-images must be >= 1")
    if (args.calibration or args.save_calibration) and args.quantize != "int8":
        raise RuntimeError(
            "--calibration/--save-calibration require --quantize int8"
        )
    calibration = None
    if args.calibration:
        calibration = serialization.load_calibration(
            args.calibration, model_config, runtime_params
        )
        print(f"Loaded int8 calibration from {args.calibration}")
    inferer = TiledInferer(
        runtime_params, model_config, tiling,
        device=device if mesh is None else None, mesh=mesh,
        quantize=None if args.quantize == "none" else args.quantize,
        calibration_images=args.calibration_images,
        calibration=calibration,
        blend_dtype=None if args.blend_dtype == "auto" else args.blend_dtype,
        reference_blend_semantics=args.reference_blend_semantics,
        plan_autotune=args.plan_autotune,
    )

    files = find_image_files(input_directory, require_ground_truth=False)
    total_image_count = len(files)
    if multihost:
        # every process runs the identical scan (a shared filesystem, the
        # same order) and keeps its stride-P shard
        files = files[rank::world]
        print(f"images in dataset: {total_image_count}; this process infers "
              f"{len(files)} (stride {world} from {rank})")
    pipeline_depth = max(1, args.pipeline_depth)
    image_batch = max(1, args.image_batch)

    # ---- reader threads: paths -> samples (annonet_infer_main.cpp:382-401).
    # Each result is tagged with its file index and the consumer reorders,
    # so images are processed in find_image_files order whatever the
    # reader count. The read-ahead window (``read_ahead``): a reader takes
    # a new request only while fewer samples than the window are taken and
    # not consumed, so one slow image cannot let the others decode the
    # whole list into the reorder buffer; requests are taken in index
    # order, so the needed index is always inside the window: no deadlock.
    read_requests: "queue.Queue" = queue.Queue()
    for index, filenames in enumerate(files):
        read_requests.put((index, filenames))
    reader_count = max(1, args.full_image_reader_thread_count)
    read_results: "queue.Queue" = queue.Queue(maxsize=reader_count)
    stop = threading.Event()
    read_ahead = threading.Semaphore(reader_count + pipeline_depth * image_batch + 2)

    def reader():
        while not stop.is_set():
            if not read_ahead.acquire(timeout=0.1):
                continue
            try:
                index, filenames = read_requests.get_nowait()
            except queue.Empty:
                read_ahead.release()
                return
            try:
                sample = read_sample(
                    filenames, anno_classes, require_ground_truth=False,
                    downscaling_factor=downscaling_factor,
                    grayscale=model_config.grayscale,
                )
            except Exception as e:  # noqa: BLE001 — raised by the consumer
                sample = e
            read_results.put((index, sample))

    readers = [threading.Thread(target=reader, daemon=True) for _ in range(reader_count)]
    for t in readers:
        t.start()
    ordered_samples = IndexOrderedResults(read_results)

    # ---- writer threads: results -> PNGs (annonet_infer_main.cpp:403-419)
    writer_count = max(1, args.result_image_writer_thread_count)
    write_requests: "queue.Queue" = queue.Queue(maxsize=writer_count)
    write_results: "queue.Queue" = queue.Queue()

    def writer():
        while True:
            item = write_requests.get()
            if item is None:
                return
            filename, original_w, original_h, result = item
            try:
                label_image = resize_label_image(result, original_w, original_h)
                save_png_rgba(
                    filename, index_label_image_to_rgba_label_image(label_image, anno_classes)
                )
                write_results.put(True)
            except Exception as e:  # noqa: BLE001 — raised by the main thread
                write_results.put(e)

    writers = [threading.Thread(target=writer, daemon=True) for _ in range(writer_count)]
    for t in writers:
        t.start()

    set_low_priority()  # annonet_infer_main.cpp:375

    per_image_records: list = []
    confusion_matrix_per_pixel = new_confusion_matrix(len(anno_classes))
    confusion_matrix_per_region = new_confusion_matrix(len(anno_classes))
    ground_truth_count = 0
    total_inference = 0.0
    total_inference_excl_first = 0.0
    max_inference_excl_first = 0.0
    excl_first_count = 0

    # The device pipeline: the next group's forward is dispatched before
    # the previous group's labels are taken, so the device's work overlaps
    # the host's blob veto and confusion matrices. Each group's copy to the
    # host is queued at the end of its own dispatch and waited for by its
    # own event (HostReadback): on one CUDA stream a plain copy in
    # complete_group would queue behind the next group's forward. Depth 1
    # is the reference's sequential loop (annonet_infer_main.cpp:440-494).
    in_flight: "collections.deque" = collections.deque()
    completed = 0
    dispatched = 0
    pending_sample = [None]  # one-sample pushback for size-group breaks
    last_image = [None]  # the most recent pixels, for the int8 overshoot line

    def next_sample():
        if pending_sample[0] is not None:
            sample, pending_sample[0] = pending_sample[0], None
            return sample
        sample = ordered_samples.next()
        read_ahead.release()  # one consumed -> one more may be read ahead
        if isinstance(sample, Exception):
            raise sample
        if sample.error:
            raise RuntimeError(sample.error)
        return sample

    def dispatch_group():
        # up to --image-batch CONSECUTIVE same-size images share one
        # forward; a size change closes the group (the odd sample is pushed
        # back, order preserved)
        nonlocal dispatched
        group = [next_sample()]
        dispatched += 1
        shape = group[0].input_image.shape
        while len(group) < image_batch and dispatched < len(files):
            sample = next_sample()
            if sample.input_image.shape != shape:
                pending_sample[0] = sample
                break
            group.append(sample)
            dispatched += 1
        t_start = time.monotonic()
        if len(group) == 1:
            labels, seeds = inferer.infer_arrays(
                group[0].input_image, gains, detection_levels, device_output=True,
            )
        else:
            labels, seeds = inferer.infer_arrays_batch(
                np.stack([s.input_image for s in group]), gains, detection_levels,
                device_output=True,
            )
        readback = HostReadback(labels, seeds, shape[0], shape[1])
        in_flight.append((group, readback, t_start))

    # the end of the previous group's measured interval (complete_group)
    prev_group_done = [None]
    completed_groups = [0]

    def complete_group():
        nonlocal total_inference, total_inference_excl_first
        nonlocal max_inference_excl_first, ground_truth_count, completed
        nonlocal excl_first_count
        group, readback, t_start = in_flight.popleft()
        labels_np, seeds_np = readback.wait()
        t_done = time.monotonic()
        # The reference times each inference strictly sequentially
        # (annonet_infer_main.cpp:466-480). With groups in flight, the wall
        # time from dispatch to readback would count overlap twice, so each
        # group is charged only the interval after the previous group
        # finished: the device runs groups in dispatch order, so t_done -
        # max(t_start, prev_done) is this group's device-busy time (+ its
        # readback); at depth 1 it is t_done - t_start.
        if prev_group_done[0] is None:
            duration = t_done - t_start
        else:
            duration = t_done - max(t_start, prev_group_done[0])
        prev_group_done[0] = t_done
        # the whole first group pays one-time costs (library load, plan
        # constants, calibration), like the reference's first image: none
        # of its images counts in the excluding-first statistics
        first_group = completed_groups[0] == 0
        completed_groups[0] += 1
        share = duration / len(group)
        for j, sample in enumerate(group):
            sel = (j,) if len(group) > 1 else ()
            result = detection_veto(labels_np[sel], None if seeds_np is None else seeds_np[sel])
            if args.report_json:
                per_image_records.append({
                    "image": sample.image_filenames.image_filename,
                    "width": sample.original_width,
                    "height": sample.original_height,
                    "milliseconds": round(share * 1000.0, 3),
                    "first_group": first_group,
                })
            total_inference += share
            if not first_group:
                total_inference_excl_first += share
                max_inference_excl_first = max(max_inference_excl_first, share)
                excl_first_count += 1
            ground_truth_count += update_confusion_matrix_per_pixel(
                confusion_matrix_per_pixel,
                sample.labeled_points_by_class,
                result,
            )
            if sample.label_image is not None:
                update_confusion_matrix_per_region(
                    confusion_matrix_per_region,
                    sample.labeled_points_by_class,
                    sample.label_image,
                    result,
                )
            write_requests.put((
                sample.image_filenames.image_filename + "_result.png",
                sample.original_width,
                sample.original_height,
                result,
            ))
            last_image[0] = sample.input_image
            completed += 1

    t0 = time.monotonic()
    try:
        with profiler_trace(args.profile, device):
            while dispatched < len(files):
                dispatch_group()
                print(f"\rProcessing image {dispatched} of {len(files)}...",
                      end="", flush=True)
                if len(in_flight) >= pipeline_depth:
                    complete_group()
            while in_flight:
                complete_group()
        t1 = time.monotonic()
        print(f"\nAll {len(files)} images processed in {t1 - t0:.3f} seconds!"
              f" (actual inference: {total_inference:.6f} seconds)")
        if len(files) > 1 and excl_first_count > 0:
            print(
                "Processing time excluding the first image: "
                f"average = {total_inference_excl_first * 1000.0 / excl_first_count:.3f} ms, "
                f"max = {max_inference_excl_first * 1000.0:.3f} ms"
            )
        for _ in range(completed):
            ok = write_results.get()
            if isinstance(ok, Exception):
                raise ok
        print("All result images written!")
        if args.plan_autotune:
            for key, report in sorted(inferer.autotune_reports.items()):
                parts = ", ".join(
                    f"{p.tile_height}x{p.tile_width}x{p.tile_count}"
                    + (f" = {r:.1f} Mpx/s" if r else "")
                    for p, r in report
                )
                print(f"Plan autotune for canvas {key[0]}x{key[1]}: "
                      f"chose {parts.split(',')[0].strip()} (candidates: {parts})")
    finally:
        # clean shutdown on success and on error: stop the readers (draining
        # read_results so that none stays blocked on the full queue), then
        # send the writers their sentinels and join everything
        stop.set()
        while any(t.is_alive() for t in readers):
            try:
                read_results.get(timeout=0.05)
            except queue.Empty:
                pass
        for _ in writers:
            write_requests.put(None)
        for t in writers + readers:
            t.join(timeout=5.0)

    if args.quantize == "int8" and last_image[0] is not None:
        # clip-saturation telemetry: how far the last image's activations
        # exceed the frozen calibration range (above ~1.2x the calibration
        # images were unrepresentative)
        overshoot = inferer.calibration_overshoot(last_image[0])
        if overshoot > 0.0:
            print(
                "int8 calibration: "
                f"{inferer.calibration_images} image(s); activation "
                f"range overshoot on the last image = {overshoot:.2f}x"
                + (" (consider raising --calibration-images)"
                   if overshoot > 1.2 else "")
            )
    wall_seconds = t1 - t0
    if multihost:
        (ground_truth_count, total_inference, total_inference_excl_first,
         excl_first_count, max_inference_excl_first, wall_seconds) = _merge_run(
            world, confusion_matrix_per_pixel, confusion_matrix_per_region,
            ground_truth_count, total_inference, total_inference_excl_first,
            excl_first_count, max_inference_excl_first, wall_seconds,
        )
        if io_process:
            print(f"\nCluster totals: {total_image_count} images across {world} "
                  f"processes in {wall_seconds:.3f} seconds (summed device "
                  f"inference: {total_inference:.6f} seconds)")
            if excl_first_count > 0:
                print(
                    "Cluster processing time excluding each process's first image: "
                    f"average = {total_inference_excl_first * 1000.0 / excl_first_count:.3f} ms, "
                    f"max = {max_inference_excl_first * 1000.0:.3f} ms"
                )
        if args.save_calibration:
            _merge_and_save_calibration(args.save_calibration, inferer, world,
                                        io_process, model_config, runtime_params)
    elif args.save_calibration:
        exported = inferer.export_calibration()
        if exported is None:
            print("No int8 net was frozen; nothing to save "
                  "(fewer images than --calibration-images?)")
        else:
            serialization.save_calibration(
                args.save_calibration, exported, model_config, runtime_params
            )
            print(f"Saved int8 calibration to {args.save_calibration}")

    if ground_truth_count and io_process:
        print("\nConfusion matrix per pixel:")
        print(format_confusion_matrix(confusion_matrix_per_pixel, anno_classes))
        print("\nConfusion matrix per region (two-way):")
        print(format_confusion_matrix(confusion_matrix_per_region, anno_classes))

    if args.report_json and not io_process:
        print("Multi-host: only process 0 writes --report-json "
              "(it holds the merged matrices and timing)")
    if args.report_json and io_process:
        import json

        from annonet_tpu_torch.infer.evaluation import confusion_matrix_summary

        report = {
            "model": args.model,
            "input_directory": input_directory,
            # the whole directory; under --coordinator per_image covers only
            # this process's shard, the matrices and timings the cluster
            "images": total_image_count,
            "processes": world,
            "quantize": args.quantize,
            "image_batch": image_batch,
            "pipeline_depth": pipeline_depth,
            "device": str(inferer.device),
            "gains": [float(g) for g in gains],
            "detection_levels": [float(d) for d in detection_levels],
            "wall_seconds": round(wall_seconds, 6),
            "inference_seconds": round(total_inference, 6),
            "excluding_first": (
                {
                    "average_ms": round(
                        total_inference_excl_first * 1000.0 / excl_first_count, 3
                    ),
                    "max_ms": round(max_inference_excl_first * 1000.0, 3),
                    "count": excl_first_count,
                }
                if excl_first_count > 0 else None
            ),
            "per_image": per_image_records,
            "confusion_per_pixel": (
                confusion_matrix_summary(confusion_matrix_per_pixel, anno_classes)
                if ground_truth_count else None
            ),
            "confusion_per_region": (
                confusion_matrix_summary(confusion_matrix_per_region, anno_classes)
                if ground_truth_count else None
            ),
        }
        with open(args.report_json, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=1)
            fh.write("\n")
        print(f"Report written to {args.report_json}")
    return 0


def _all_gather_rows(row, world: int):
    """[world, len(row)] float64: every process's ``row``, in rank order
    (one gloo all-gather; counts below 2**53 ride float64 exactly)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    local = torch.from_numpy(np.ascontiguousarray(row, dtype=np.float64))
    rows = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(rows, local)
    return torch.stack(rows).numpy()


def _merge_run(world, cm_pixel, cm_region, ground_truth_count, total_inference,
               total_inference_excl_first, excl_first_count,
               max_inference_excl_first, wall_seconds):
    """The JAX CLI's end-of-run merge: ONE all-gather carries the scalars
    and both flattened confusion matrices; the matrices are summed in
    place, and the merged (ground truth count, inference seconds, seconds
    excluding each first image, their count, max, wall) returned."""
    import numpy as np

    k2 = cm_pixel.size
    gathered = _all_gather_rows(np.concatenate([
        np.asarray([ground_truth_count, total_inference, total_inference_excl_first,
                    excl_first_count, max_inference_excl_first, wall_seconds],
                   np.float64),
        cm_pixel.astype(np.float64).ravel(),
        cm_region.astype(np.float64).ravel(),
    ]), world)
    cm_pixel[...] = gathered[:, 6 : 6 + k2].sum(axis=0).reshape(cm_pixel.shape)
    cm_region[...] = gathered[:, 6 + k2 :].sum(axis=0).reshape(cm_region.shape)
    return (int(gathered[:, 0].sum()), float(gathered[:, 1].sum()),
            float(gathered[:, 2].sum()), int(gathered[:, 3].sum()),
            float(gathered[:, 4].max()), float(gathered[:, 5].max()))


def _merge_and_save_calibration(path, inferer, world, io_process, model_config,
                                runtime_params):
    """Merge every process's activation maxima (element-wise max of the
    per-layer, per-channel vectors, accumulations that have not frozen
    included) so the saved file covers the whole directory; process 0
    writes it. Every process joins the fixed-shape all-gather: one with
    nothing to contribute sends zeros (the identity of a max of post-ReLU
    maxima) and a trailing flag of 0, so "no process calibrated" stays
    apart from all-zero activations."""
    import numpy as np

    from annonet_tpu_torch import serialization

    lengths = inferer.calibration_layer_shapes()
    if lengths is None:
        if io_process:
            print("No int8 net was frozen; nothing to save "
                  "(this config cannot fold to int8)")
        return
    flat = np.zeros(sum(lengths) + 1, np.float64)
    local = inferer.export_calibration(partial=True)
    if local is not None:
        flat[:-1] = np.concatenate([np.asarray(v, np.float64).ravel() for v in local]
                                   or [np.zeros(0, np.float64)])
        flat[-1] = 1.0
    ranks = _all_gather_rows(flat, world)
    contributed = int(ranks[:, -1].sum())
    if not io_process:
        return
    if contributed == 0:
        print("No int8 net was frozen; nothing to save "
              "(fewer images than --calibration-images?)")
        return
    merged_flat = ranks[:, :-1].max(axis=0).astype(np.float32)
    merged = np.split(merged_flat, np.cumsum(lengths)[:-1])
    serialization.save_calibration(path, merged, model_config, runtime_params)
    print(f"Saved int8 calibration to {path} (maxima merged across "
          f"{contributed} of {world} processes)")


if __name__ == "__main__":
    sys.exit(main())
